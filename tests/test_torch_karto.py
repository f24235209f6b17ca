"""Port parity for the online Karto slice: tpu_slam_torch's KartoSLAM
against tpu_slam's on examples/run_karto_slam.py's recipe (the corridor
loop, drifting odometry from default_rng(3)), the state carried across
through the reference's checkpoint, and the solver's card route for small
graphs. Both packages get the same scans and odometry; the port runs on the
CPU (device="cpu"), where its matcher takes the kernel's plain version and
its solver the dense LM, the reference's routes off the TPU."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import index_scan as jindex_scan
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.karto.pipeline import KartoSLAM as JKartoSLAM
from tpu_slam.models.karto.pipeline import LaserRig as JLaserRig
from tpu_slam.utils.checkpoint import load_karto as jload_karto
from tpu_slam.utils.checkpoint import save_karto as jsave_karto
from tpu_slam.utils.evaluation import ate_rmse
from tpu_slam_torch import _dispatch
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.convert import karto_state_from_checkpoint, scan_from_numpy
from tpu_slam_torch.data.scan import index_scan
from tpu_slam_torch.models.karto.pipeline import (
    DeviceScanStore, KartoSLAM, LaserRig,
)
from tpu_slam_torch.solver.pose_graph import _route
from tpu_slam_torch.utils.checkpoint import save_karto

from test_karto import drifted_odometry, small_karto_cfg
from test_torch_host_copies import port_config

# measured: 5.4e-5 m at the small config (the dense LM's float32 sums run
# in another order in the two packages); 2.4e-7 m at the full width
POSE_ATOL = 1e-4
FULL_POSE_ATOL = 1e-5
FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")


def _recipe(cfg, n=None):
    """The corridor loop of examples/run_karto_slam.py (352 scans, or the
    first ``n``): the JAX scans on the host, the port's on the CPU, the
    ground truth and the drifting odometry."""
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:n]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = jax.tree_util.tree_map(np.asarray, jmake_scan(
        seq.ranges, cfg.scan, stamp=seq.stamps.astype(np.float32)))
    tscans = scan_from_numpy(*(getattr(scans, f) for f in FIELDS),
                             device="cpu")
    return scans, tscans, seq.gt_poses, odom


def _assert_same_mapper(port, ref, atol, offset=0):
    """The same scans, graph edges (from ``offset`` on) and closures, and
    corrected poses within ``atol``."""
    assert len(port.scans) == len(ref.scans)
    assert port.loop_closures == ref.loop_closures
    assert port.graph_edges == ref.graph_edges[offset:]
    assert port.solver.num_edges == ref.solver.num_edges
    assert [(e[0], e[1]) for e in port.solver._edges] == [
        (e[0], e[1]) for e in ref.solver._edges]
    tp = np.stack([r.corrected_pose for r in port.scans])
    jp = np.stack([r.corrected_pose for r in ref.scans])
    np.testing.assert_allclose(tp, jp, atol=atol, rtol=0)
    np.testing.assert_allclose(port.map_to_odom(), ref.map_to_odom(),
                               atol=atol, rtol=0)
    for name, st in ref.sensors.items():
        assert list(port.sensors[name].running) == list(st.running)


def test_small_config_run_matches_reference():
    """The whole 352-scan recipe at test_karto.py's small_karto_cfg (180
    beams, 5 m, 0.02 m grid): both packages accept the same scans, build
    the same graph (near-chain matches and one loop closure included) and
    land on the same poses."""
    cfg = small_karto_cfg()
    scans, tscans, gt, odom = _recipe(cfg)
    ref = JKartoSLAM(cfg)
    jacc = ref.run(scans, odom)
    port = KartoSLAM(port_config(cfg), device="cpu")
    before = dict(_dispatch.LAUNCHES)
    tacc = port.run(tscans, odom)
    assert _dispatch.LAUNCHES == before  # the CPU runs no kernel
    np.testing.assert_array_equal(tacc, jacc)
    assert ref.loop_closures >= 1 and ref.timer.counts["near_match"] > 0
    assert port.timer.counts["near_match"] == ref.timer.counts["near_match"]
    _assert_same_mapper(port, ref, POSE_ATOL)
    np.testing.assert_allclose(port.trajectory(), ref.trajectory(),
                               atol=POSE_ATOL, rtol=0)
    ate_ref = ate_rmse(ref.trajectory(), gt[jacc])
    assert ate_rmse(port.trajectory(), gt[tacc]) == pytest.approx(
        ate_ref, abs=POSE_ATOL)
    assert ate_ref < 0.06


def test_state_carried_across_from_the_reference(tmp_path):
    """The JAX package's checkpoint after 50 scans loads into the port
    (convert.karto_state_from_checkpoint); both then process the next 40
    scans with the speculative front match and stay equal. The port's own
    snapshot of the result loads back into both packages."""
    cfg = small_karto_cfg()
    scans, tscans, _gt, odom = _recipe(cfg, n=90)
    ref = JKartoSLAM(cfg)
    for t in range(50):
        ref.process(jindex_scan(scans, t), odom[t],
                    lookahead=(jindex_scan(scans, t + 1), odom[t + 1]))
    path = str(tmp_path / "ref.npz")
    jsave_karto(ref, path)
    n_edges = len(ref.graph_edges)
    port = karto_state_from_checkpoint(
        KartoSLAM(port_config(cfg), device="cpu"), path)
    assert port._stores[179].count == len(ref.scans)
    _assert_same_mapper(port, ref, 0.0, offset=n_edges)
    for t in range(50, 89):
        la = ((jindex_scan(scans, t + 1), odom[t + 1]),
              (index_scan(tscans, t + 1), odom[t + 1]))
        acc_ref = ref.process(jindex_scan(scans, t), odom[t], lookahead=la[0])
        acc_port = port.process(index_scan(tscans, t), odom[t],
                                lookahead=la[1])
        assert acc_port == acc_ref, t
    _assert_same_mapper(port, ref, POSE_ATOL, offset=n_edges)

    path2 = str(tmp_path / "port.npz")
    save_karto(port, path2)
    back = karto_state_from_checkpoint(
        KartoSLAM(port_config(cfg), device="cpu"), path2)
    ref2 = JKartoSLAM(cfg)
    jload_karto(ref2, path2)
    for m in (back, ref2):
        np.testing.assert_array_equal(
            np.stack([r.corrected_pose for r in m.scans]),
            np.stack([r.corrected_pose for r in port.scans]))
        assert m.adjacency == port.adjacency
        assert m.solver.num_edges == port.solver.num_edges


def test_small_graphs_route_to_the_pcg_kernel_on_the_card():
    """On the TPU the reference sends a graph of ≤ use_dense_below nodes to
    its fused LM kernel under use_fused_kernel, cg_restarts ≤ 1 and no
    Schur, where its 256-rounded node and edge counts fit the power-of-two
    buckets and the one-hot cap; else, and off the TPU, to its dense LM.
    The port routes the same by device, without a card needed to check the
    choice. The online Karto recipe's graphs (≤ 126 nodes, 127 edges)
    stay dense."""
    cfg = SolverConfig()
    assert _route(200, 200, "cuda", cfg) == "pcg"
    assert _route(200, 200, torch.device("cuda", 0), cfg) == "pcg"
    assert _route(512, 600, "cuda", cfg) == "pcg"
    assert _route(200, 200, "cpu", cfg) == "dense"
    for off in (dict(use_fused_kernel=False), dict(cg_restarts=2),
                dict(use_schur=True)):
        assert _route(200, 200, "cuda",
                      dataclasses.replace(cfg, **off)) == "dense"
    # the rounded shapes pass their buckets at ≤ 128 nodes or edges
    for n, e in ((126, 127), (128, 300), (300, 128), (2, 1)):
        assert _route(n, e, "cuda", cfg) == "dense"
    assert _route(129, 129, "cuda", cfg) == "pcg"
    # the one-hot cap: 512 × 6,400 > 3.2 M
    assert _route(512, 6000, "cuda", cfg) == "pcg"
    assert _route(512, 6300, "cuda", cfg) == "dense"
    # larger graphs keep their routes, on either device
    for dev in ("cuda", "cpu"):
        assert _route(1056, 1200, dev, cfg, lambda: None) == "pcg"
        assert _route(1024, 1100, dev, cfg, lambda: object()) == "direct"
        assert _route(4000, 4100, dev, cfg, lambda: None) == "host_f64"
        assert _route(1024, 1100, dev,
                      dataclasses.replace(cfg, use_schur=True)) == "schur"
    # the band spec is asked for only above use_dense_below
    assert _route(200, 200, "cuda", cfg, lambda: 1 / 0) == "pcg"


def test_stationary_gates_and_rig_are_the_same():
    cfg = small_karto_cfg()
    scans, tscans, _gt, odom = _recipe(cfg, n=3)
    cfg2 = dataclasses.replace(cfg, karto=dataclasses.replace(
        cfg.karto, minimum_time_interval=5.0))
    ref = JKartoSLAM(cfg2)
    port = KartoSLAM(port_config(cfg2), device="cpu")
    s0, t0 = jindex_scan(scans, 0), index_scan(tscans, 0)
    for stamp, expect in ((0.0, True), (1.0, False), (6.0, True)):
        js = dataclasses.replace(s0, stamp=np.float32(stamp))
        ts = dataclasses.replace(t0, stamp=torch.tensor(stamp))
        assert ref.process(js, odom[0]) == expect
        assert port.process(ts, odom[0]) == expect
    assert len(port.scans) == len(ref.scans) == 2
    for mount in ((0.2, 0.0, 0.1, 0.0, 0.0, 0.5),
                  (0.2, 0.0, 0.1, np.pi, 0.0, 0.5),
                  (0.0, 0.0, 0.0, 0.0, np.pi, 0.0)):
        assert LaserRig.from_mount(*mount) == LaserRig(
            **dataclasses.asdict(JLaserRig.from_mount(*mount)))


def test_chip_smoke_odometry_is_the_references():
    """chip_smoke.py drives the recipe without JAX: its drifting odometry
    is test_karto.drifted_odometry's, bit for bit."""
    import chip_smoke

    gt = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:120]
    np.testing.assert_array_equal(chip_smoke.drifted_odometry(gt),
                                  drifted_odometry(gt, seed=3))


def test_device_scan_store_grows_and_keeps_rows():
    rng = np.random.default_rng(0)
    store = DeviceScanStore(5, init_cap=2, device="cpu")
    rows = [(rng.normal(size=(5, 2)).astype(np.float32), rng.random(5) > 0.3)
            for _ in range(9)]
    rows[3][0][1] = np.nan  # NaN points of non-finite beams are stored
    for k, (p, v) in enumerate(rows):
        assert store.append(p, v) == k
    assert store.count == 9 and store.pts.shape == (32, 5, 2)
    for k, (p, v) in enumerate(rows):
        np.testing.assert_array_equal(store.pts[k].numpy(), p)
        np.testing.assert_array_equal(store.valid[k].numpy(), v)
    assert not store.valid[9:].any() and not store.pts[9:].any()


def test_unported_surfaces_raise():
    """The mesh surfaces are ported: over a mesh of one rank the solver is
    edge-sharded and the keyframe ring-pass gives the host's distances
    (test_torch_mesh_models.py runs two ranks against the reference)."""
    from tpu_slam_torch.parallel.mesh import make_mesh

    cfg = port_config(small_karto_cfg())
    mesh = make_mesh(device="cpu")
    slam = KartoSLAM(cfg, device="cpu", mesh=mesh)
    assert slam.solver.mesh is mesh
    refs = np.random.default_rng(0).uniform(-8, 8, (37, 2))
    d2 = slam._ring_distances(refs[5], refs)
    assert d2.shape == (37,) and d2.dtype == np.float64
    np.testing.assert_allclose(d2, np.sum((refs - refs[5]) ** 2, -1),
                               rtol=1e-5, atol=1e-4)
    slam = KartoSLAM(cfg, device="cpu")
    # the offline missions' multi-query anchor matcher is ported now
    assert callable(slam.loop_matcher._full_anchor_store(1, 16, (512, 179),
                                                         True, True))


@pytest.mark.slow
def test_full_width_run_matches_reference():
    """The recipe at the full default_config() (360 beams, 12 m, the
    2,445² front grid and 645² loop grid): the reference gives 126
    accepted scans, 2 closures, 127 edges and ATE 0.00577 m on the CPU;
    the port the same scans, graph and poses within 1e-5 m."""
    cfg = default_config()
    scans, tscans, gt, odom = _recipe(cfg)
    ref = JKartoSLAM(cfg)
    jacc = ref.run(scans, odom)
    port = KartoSLAM(port_config(cfg), device="cpu")
    tacc = port.run(tscans, odom)
    np.testing.assert_array_equal(tacc, jacc)
    assert (len(jacc), ref.loop_closures, ref.solver.num_edges) == (126, 2,
                                                                   127)
    _assert_same_mapper(port, ref, FULL_POSE_ATOL)
    assert ate_rmse(port.trajectory(), gt[tacc]) < 0.01
