"""GMapping in tpu_slam_torch against tpu_slam on examples/run_gmapping.py's
recipe cut to 60 scans of 180 beams: the same counters and map, and the
reference's counters carried across (``convert.gmapping_state_from_numpy``)
after which both packages continue to the same map."""

import dataclasses

import jax
import numpy as np
import pytest

from tpu_slam.config import default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import index_scan as jindex_scan
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.gmapping import GMapping as JGMapping
from tpu_slam_torch.convert import gmapping_state_from_numpy, scan_from_numpy
from tpu_slam_torch.data.scan import index_scan
from tpu_slam_torch.models.gmapping import GMapping

from test_torch_host_copies import port_config

FIELDS = ("ranges", "valid", "angles", "stamp", "time_increment")
N_SCANS = 60


@pytest.fixture(scope="module")
def recipe():
    """The corridor loop (arm 9 m, width 2.6 m, 0.9 m/s), noise 0.004,
    seed 6, at 180 beams on a 512² grid: the config, the JAX scans, the
    port's (CPU) and the true poses as float32."""
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg, scan=dataclasses.replace(cfg.scan, num_beams=180,
                                      angle_increment=2 * np.pi / 180),
        grid=dataclasses.replace(cfg.grid, size_x=512, size_y=512,
                                 origin_x=-12.8, origin_y=-12.8))
    traj = sim.loop_trajectory(arm=9.0, width=2.6, speed=0.9)[:N_SCANS]
    world = sim.corridor_loop_world(arm=9.0, width=2.6)
    seq = sim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                seed=6)
    scans = jax.tree_util.tree_map(np.asarray,
                                   jmake_scan(seq.ranges, cfg.scan))
    tscans = scan_from_numpy(*(getattr(scans, f) for f in FIELDS),
                             device="cpu")
    return cfg, scans, tscans, seq.gt_poses.astype(np.float32)


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.hits.numpy(), np.asarray(ref.hits))
    np.testing.assert_array_equal(port.visits.numpy(),
                                  np.asarray(ref.visits))
    np.testing.assert_allclose(port.acc.numpy(), np.asarray(ref.acc),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(port.cell_means(), ref.cell_means(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(port.to_ros_map(), ref.to_ros_map())


def test_gmapping_run_matches_reference(recipe):
    cfg, scans, tscans, poses = recipe
    ref = JGMapping(cfg)
    ref.run(scans, poses)
    port = GMapping(port_config(cfg), device="cpu")
    port.run(tscans, poses)
    _assert_same(port, ref)
    m = port.to_ros_map()
    assert m.dtype == np.int8 and m.shape == (512, 512)
    assert (m == 100).sum() > 200 and (m == 0).sum() > 10_000
    assert port.cell_means().shape == (512, 512, 2)


def test_gmapping_state_carried_across(recipe):
    """The reference's counters after 30 scans load into the port; both
    add the next 30 scans one at a time and end on the same map."""
    cfg, scans, tscans, poses = recipe
    ref = JGMapping(cfg)
    for t in range(30):
        ref.add_scan(jindex_scan(scans, t), poses[t])
    port = gmapping_state_from_numpy(
        GMapping(port_config(cfg), device="cpu"), np.asarray(ref.hits),
        np.asarray(ref.visits), np.asarray(ref.acc))
    _assert_same(port, ref)
    for t in range(30, N_SCANS):
        ref.add_scan(jindex_scan(scans, t), poses[t])
        port.add_scan(index_scan(tscans, t), poses[t])
    _assert_same(port, ref)
    with pytest.raises(ValueError, match="cells"):
        gmapping_state_from_numpy(port, np.zeros(5), np.zeros(5),
                                  np.zeros((5, 2)))
