"""Port parity for the mesh forms of the models: PoseGraphSolver(mesh),
offline_slam(mesh), KartoSLAM(mesh) and HectorSLAM(mesh) of
tpu_slam_torch against tpu_slam's, and the mesh route order.

The port runs at D = 2 in gloo ranks on the CPU (``torch_mesh_ranks``),
and once more without a mesh in a process of its own, side by side; then
the reference runs here on ``make_mesh(2)`` over conftest's virtual CPU
devices. Each run holds the port at D = 2
against the reference at D = 2 and against the port's single-device run,
to the reference's own bars: poses 5e-4 and cost 1e-2 relative for the
solver (``tests/test_pose_graph.py:128``); the chain 1e-5, the same loop
count and poses 5e-4 for the offline mission (on
``tests/test_offline.py:56``'s corridor); the same accepted scans and
closures and a trajectory within 5e-3 for Karto; a trajectory within
1e-4 and the same maps for Hector (``tests/test_hector.py:311``). The
recipes are short (the Karto loop has arms of 5 m: 154 scans, one
closure; Hector 60 scans); the full Karto recipe is marked slow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam.config import SolverConfig as JSolverConfig
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.hector_slam import HectorSLAM as JHectorSLAM
from tpu_slam.models.karto.pipeline import KartoSLAM as JKartoSLAM
from tpu_slam.models.offline import offline_slam as joffline_slam
from tpu_slam.parallel.mesh import make_mesh as jmake_mesh
from tpu_slam.solver.pose_graph import PoseGraphSolver as JPoseGraphSolver
from tpu_slam_torch.config import SolverConfig
from tpu_slam_torch.parallel.mesh import make_mesh
from tpu_slam_torch.solver import pose_graph as tpg

import torch_mesh_ranks as ranks
from test_hector import small_cfg as hector_cfg
from test_karto import drifted_odometry, small_karto_cfg
from test_offline import _corridor_mission
from test_pose_graph import ring_graph
from test_torch_host_copies import port_config

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")

D = 2
FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")
SOLVER_CFGS = {"dense": dict(use_dense_below=10_000),
               "cg": dict(use_dense_below=0)}


def _fields(scans):
    return tuple(np.asarray(getattr(scans, f)) for f in FIELDS)


def _graph():
    gt, edges = ring_graph(n=40, noise=0.02, seed=11)
    rng = np.random.default_rng(13)
    init = gt + rng.normal(0, 0.1, gt.shape) * (np.arange(len(gt)) > 0)[:, None]
    return init, edges, np.diag([100.0, 100.0, 400.0])


def _karto_recipe(cfg, arm=5.0):
    """The corridor loop of examples/run_karto_slam.py with arms of
    ``arm`` m (9 m there)."""
    traj = sim.loop_trajectory(arm=arm, width=2.6, speed=0.9)
    world = sim.corridor_loop_world(arm=arm, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=8)
    odom = drifted_odometry(seq.gt_poses, seed=3)
    scans = jmake_scan(seq.ranges, cfg.scan,
                       stamp=seq.stamps.astype(np.float32))
    return scans, odom


def _hector_recipe():
    cfg = hector_cfg()
    traj = sim.circle_trajectory(60, radius=1.5, angular_rate=0.6)
    world = sim.office_world(seed=31, size=10.0, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=3)
    scans = jmake_scan(seq.ranges, cfg.scan,
                       stamp=seq.stamps.astype(np.float32))
    return cfg, scans, seq.gt_poses


def _jax_pose_graph(mesh):
    init, edges, info = _graph()
    out = {}
    for name, kw in SOLVER_CFGS.items():
        s = JPoseGraphSolver(JSolverConfig(**kw), mesh=mesh)
        for i, p in enumerate(init):
            s.add_node(i, p)
        for i, j, m in edges:
            s.add_constraint(i, j, m, information=info)
        stats = s.compute()
        out[name] = (s.get_poses(), tuple(stats))
    return out


@pytest.fixture(scope="module")
def runs():
    """{"port": rank 0's results at D, "single": the port without a mesh,
    "jax": the reference at D, "ranks": every rank's results}."""
    init, edges, info = _graph()
    ocfg, oscans, oseq, oodom = _corridor_mission()
    kcfg = small_karto_cfg()
    kscans, kodom = _karto_recipe(kcfg)
    hcfg, hscans, hgt = _hector_recipe()
    cases = [
        ("pose_graph", dict(cfgs=[SolverConfig(**kw)
                                  for kw in SOLVER_CFGS.values()],
                            init=init, edges=edges, info=info)),
        ("offline", dict(cfg=port_config(ocfg), fields=_fields(oscans),
                         odom=oodom)),
        ("karto", dict(cfg=port_config(kcfg), fields=_fields(kscans),
                       odom=kodom)),
        ("hector", dict(cfg=port_config(hcfg), fields=_fields(hscans),
                        pose0=hgt[0])),
    ]
    sharded = ranks.Ranks(D, cases)
    single = ranks.Ranks(1, [(n, dict(kw, sharded=False))
                             for n, kw in cases])
    # the ranks first, so that their deadline is not spent on the
    # reference's compiles in this process
    names = [c[0] for c in cases]
    per_rank = sharded.result()
    one = single.result()[0]
    mesh = jmake_mesh(D)
    jax_out = {"pose_graph": _jax_pose_graph(mesh)}
    r = joffline_slam(oscans, ocfg, odom=oodom, mesh=mesh)
    jax_out["offline"] = {"poses": r.poses, "chain": r.chain_poses,
                          "loops": len(r.loops)}
    ks = JKartoSLAM(kcfg, mesh=mesh)
    acc = ks.run(kscans, kodom)
    jax_out["karto"] = {"accepted": list(acc), "closures": ks.loop_closures,
                        "trajectory": ks.trajectory()}
    hs = JHectorSLAM(hcfg, mesh=mesh)
    hs.last_pose = jnp.asarray(hgt[0], jnp.float32)
    jax_out["hector"] = {"est": hs.run(hscans), "maps": [
        hs.to_ros_map(level=k) for k in range(len(hs.grid_cfgs))]}
    return {"port": dict(zip(names, per_rank[0])),
            "single": dict(zip(names, one)), "jax": jax_out,
            "ranks": [dict(zip(names, r)) for r in per_rank],
            "gt": {"offline": oseq.gt_poses, "hector": hgt}}


def _every_rank_alike(runs, job, key):
    vals = [r[job][key] for r in runs["ranks"]]
    for v in vals[1:]:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(vals[0]))


@pytest.mark.parametrize("path", list(SOLVER_CFGS))
def test_pose_graph_solver_mesh(runs, path):
    k = list(SOLVER_CFGS).index(path)
    poses, stats, route, coll = runs["port"]["pose_graph"][k]
    for r in runs["ranks"]:
        np.testing.assert_array_equal(r["pose_graph"][k][0], poses)
    assert route == f"mesh_{path}"
    # one gather of the edges' terms a step (with the cost's), one a CG
    # matvec
    assert coll["all_gather"] >= 2 * stats[0]
    assert coll["psum"] == coll["ppermute"] == 0
    # the edges' terms are summed in edge order on every rank: the same
    # bits at D = 2 as on a mesh of one rank without a process group
    init, edges, info = _graph()
    one = tpg.PoseGraphSolver(SolverConfig(**SOLVER_CFGS[path]),
                              mesh=make_mesh(device="cpu"))
    one.add_nodes(range(len(init)), init)
    for i, j, m in edges:
        one.add_constraint(i, j, m, information=info)
    assert tuple(one.compute()) == stats
    np.testing.assert_array_equal(one.get_poses(), poses)
    jposes, jstats = runs["jax"]["pose_graph"][path]
    sposes, sstats, sroute, _ = runs["single"]["pose_graph"][k]
    assert sroute == {"dense": "dense", "cg": "direct"}[path]
    for ref, rstats in ((jposes, jstats), (sposes, sstats)):
        np.testing.assert_allclose(poses, ref, atol=5e-4)
        assert stats[2] == pytest.approx(rstats[2], rel=1e-2, abs=1e-6)


@pytest.mark.parametrize("nodes, kw, route", [
    # whatever the size, band or options: the mesh's dense or CG arm
    (4000, dict(use_schur=True), "mesh_cg"),
    (1000, dict(use_schur=True), "mesh_cg"),
    (4000, {}, "mesh_cg"),
    (4000, dict(host_direct_fallback=False), "mesh_cg"),
    (1000, dict(cg_restarts=2), "mesh_cg"),
    (512, {}, "mesh_dense"),
    (200, dict(cg_restarts=2, use_fused_kernel=True), "mesh_dense"),
    (130, dict(use_dense_below=100), "mesh_cg"),
])
def test_mesh_route_order(nodes, kw, route):
    cfg = SolverConfig(**kw)
    mesh = make_mesh(device="cpu")
    for dev in ("cuda", "cpu"):
        for bands in (lambda: object(), lambda: None):
            assert tpg._route(nodes, 2 * nodes, dev, cfg, bands,
                              mesh) == route


def test_offline_slam_mesh(runs):
    port, single, ref = (runs[k]["offline"] for k in ("port", "single",
                                                      "jax"))
    _every_rank_alike(runs, "offline", "poses")
    np.testing.assert_allclose(port["chain"], single["chain"], atol=1e-5)
    assert port["loops"] == single["loops"] == ref["loops"] > 0
    np.testing.assert_allclose(port["poses"], single["poses"], atol=5e-4)
    np.testing.assert_allclose(port["poses"], ref["poses"], atol=5e-4)
    np.testing.assert_allclose(port["chain"], ref["chain"], atol=1e-5)


def test_karto_mesh(runs):
    port, single, ref = (runs[k]["karto"] for k in ("port", "single", "jax"))
    _every_rank_alike(runs, "karto", "trajectory")
    assert port["accepted"] == single["accepted"] == ref["accepted"]
    assert port["closures"] == single["closures"] == ref["closures"] >= 1
    np.testing.assert_allclose(port["trajectory"], single["trajectory"],
                               atol=5e-3)
    np.testing.assert_allclose(port["trajectory"], ref["trajectory"],
                               atol=5e-3)


def test_hector_mesh(runs):
    port, single, ref = (runs[k]["hector"] for k in ("port", "single",
                                                     "jax"))
    _every_rank_alike(runs, "hector", "est")
    # each rank holds its stripe only: half of every level's cells
    assert port["stripe_cells"] == [256 * 256 // D, 128 * 128 // D,
                                    64 * 64 // D]
    np.testing.assert_allclose(port["est"], single["est"], atol=1e-4)
    np.testing.assert_allclose(port["est"], ref["est"], atol=1e-4)
    for a, b, c in zip(port["maps"], single["maps"], ref["maps"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


@pytest.mark.slow
def test_karto_mesh_full_recipe():
    """examples/run_karto_slam.py's 352-scan recipe at the small config:
    the port at D = 2 and the reference at D = 2."""
    kcfg = small_karto_cfg()
    kscans, kodom = _karto_recipe(kcfg, arm=9.0)
    job = ranks.Ranks(D, [("karto", dict(cfg=port_config(kcfg),
                                         fields=_fields(kscans),
                                         odom=kodom))], deadline=600)
    ks = JKartoSLAM(kcfg, mesh=jmake_mesh(D))
    acc = ks.run(kscans, kodom)
    port = job.result()[0][0]
    assert port["accepted"] == list(acc)
    assert port["closures"] == ks.loop_closures >= 1
    np.testing.assert_allclose(port["trajectory"], ks.trajectory(),
                               atol=5e-3)
