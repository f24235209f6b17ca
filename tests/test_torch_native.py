"""The port's native host library (tpu_slam_torch/native, its own build of
its copy of tpu_slam_native.cpp) against the reference's
(tpu_slam/native): every binding bit for bit on the same inputs, made
from a seed with numpy, and occupancy_from_scans(engine="native") against
the reference's native engine and the port's device engine on
tests/test_native.py's Karto counts recipe. The port builds with the
reference's flags, so the two libraries compute the same float32 steps."""

import dataclasses
import shutil

import numpy as np
import pytest

from tpu_slam import native as jnative
from tpu_slam.config import default_config as jdefault_config
from tpu_slam.data import rosbag as jrosbag
from tpu_slam.data import simulator as jsim
from tpu_slam.data.scan import make_scan as jmake_scan
from tpu_slam.models.karto.occupancy import (
    compute_grid_bounds, occupancy_from_scans as jocc,
)
from tpu_slam_torch import native
from tpu_slam_torch.data import rosbag
from tpu_slam_torch.models.karto.occupancy import occupancy_from_scans

from test_torch_host_copies import port_config


@pytest.fixture(scope="module", autouse=True)
def libraries():
    """Both libraries built; skipped only where there is no g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native libraries cannot be built")
    assert native.available(), native.build_error()
    assert jnative.available()


def test_library_builds_outside_the_package_with_the_reference_flags():
    path = native.library_path()
    assert path.exists()
    assert path.parent.name == "tpu_slam_torch_native"
    assert path.parent.parent.name == "build"
    assert native.CXX_FLAGS == ("-O3", "-march=native", "-shared", "-fPIC",
                                "-std=c++17")
    assert native.build_error() is None


def test_raycast_bit_equal():
    world = jsim.office_world(seed=5)
    rng = np.random.default_rng(0)
    origins = rng.uniform(-2, 2, (64, 2))
    angles = rng.uniform(-np.pi, np.pi, 64)
    a = native.raycast(world.segments, origins, angles, 12.0)
    b = jnative.raycast(world.segments, origins, angles, 12.0)
    np.testing.assert_array_equal(a, b)
    assert np.isfinite(a).sum() > 32


def test_bresenham_masks_bit_equal():
    rng = np.random.default_rng(1)
    n = 90
    ang = np.linspace(-np.pi, np.pi, n, endpoint=False)
    r = rng.uniform(1.0, 5.5, n)
    oc = np.array([64.3, 61.8])
    ec = oc + 10 * np.stack([r * np.cos(ang), r * np.sin(ang)], -1)
    valid = rng.random(n) > 0.1
    for a, b in zip(native.bresenham_masks(oc, ec, valid, 128, 128),
                    jnative.bresenham_masks(oc, ec, valid, 128, 128)):
        np.testing.assert_array_equal(a, b)
        assert a.any()


def test_decimate_bit_equal():
    r = np.random.default_rng(2).uniform(0.1, 9.0, 361).astype(np.float32)
    r[::17] = np.nan
    for factor in (1, 2, 3, 7):
        np.testing.assert_array_equal(native.decimate(r, factor),
                                      jnative.decimate(r, factor))


def _counts_recipe():
    """tests/test_native.py::test_native_karto_counts_matches_device's
    recipe: 24 scans of 120 beams around an office, true poses."""
    cfg = jdefault_config()
    cfg = dataclasses.replace(
        cfg, scan=dataclasses.replace(
            cfg.scan, num_beams=120, range_max=6.0, range_threshold=5.0))
    traj = jsim.circle_trajectory(24, radius=1.4, angular_rate=0.6)
    world = jsim.office_world(seed=9, clear_path=traj)
    seq = jsim.simulate_sequence(world, traj, cfg.scan, noise_std=0.004,
                                 seed=3)
    scans = jmake_scan(seq.ranges, cfg.scan)
    ranges = np.asarray(scans.ranges)
    with np.errstate(invalid="ignore"):
        pts = np.asarray(scans.points()).astype(np.float32)
    pts[~np.isfinite(pts)] = 0.0
    poses = seq.gt_poses.astype(np.float32)
    grid = compute_grid_bounds(poses, cfg.scan.range_threshold, 0.05)
    return cfg, grid, poses, pts, ranges


def test_karto_counts_bit_equal():
    cfg, grid, poses, pts, ranges = _counts_recipe()
    c, s = np.cos(poses[:, 2])[:, None], np.sin(poses[:, 2])[:, None]
    ends = np.stack([poses[:, 0:1] + c * pts[..., 0] - s * pts[..., 1],
                     poses[:, 1:2] + s * pts[..., 0] + c * pts[..., 1]], -1)
    args = (poses[:, :2], ends, ranges)
    kw = dict(min_range=cfg.scan.range_min, max_range=cfg.scan.range_max)
    a = native.karto_counts(*args, port_config(grid), 5.0, **kw)
    b = jnative.karto_counts(*args, grid, 5.0, **kw)
    for x, y in zip(a, b):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert a[1].sum() > 1000


def test_native_engine_equals_reference_and_device_engine():
    cfg, grid, poses, pts, ranges = _counts_recipe()
    kw = dict(min_range=cfg.scan.range_min, max_range=cfg.scan.range_max)
    args = (poses, pts, ranges, cfg.scan.range_threshold)
    m_nat = occupancy_from_scans(port_config(grid), *args, engine="native",
                                 device="cpu", **kw)
    m_dev = occupancy_from_scans(port_config(grid), *args, engine="device",
                                 device="cpu", **kw)
    m_ref = jocc(grid, *args, engine="native", **kw)
    assert m_nat.dtype == np.int8
    np.testing.assert_array_equal(m_nat, m_ref)
    np.testing.assert_array_equal(m_nat, m_dev)
    assert (m_nat == 100).sum() > 100 and (m_nat == 0).sum() > 1000


def test_native_engine_raises_without_the_library(monkeypatch):
    cfg, grid, poses, pts, ranges = _counts_recipe()
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        occupancy_from_scans(port_config(grid), poses, pts, ranges, 5.0,
                             engine="native", device="cpu")


def _bag(tmp_path, compression):
    """tests/test_native.py's bag: 5 scans of 61 beams (NaN and inf among
    them), IMU and odometry, written by the reference."""
    rng = np.random.default_rng(7)
    msgs = []
    for i in range(5):
        r = rng.uniform(0.3, 7.0, 61).astype(np.float32)
        r[i::13] = np.nan
        r[(i + 5)::17] = np.inf
        scan = {"stamp": 10.0 + 0.1 * i, "angle_min": -1.5, "angle_max": 1.5,
                "angle_increment": 0.05, "time_increment": 1e-4,
                "scan_time": 0.1, "range_min": 0.1, "range_max": 8.0,
                "ranges": r}
        msgs.append(("scan", "sensor_msgs/LaserScan", scan["stamp"],
                     jrosbag.serialize_laser_scan(scan)))
        msgs.append(("imu", "sensor_msgs/Imu", scan["stamp"],
                     jrosbag.serialize_imu(scan["stamp"], 0.1 * i,
                                           [0.0, 0.0, 0.2 + 0.01 * i])))
        msgs.append(("odom", "nav_msgs/Odometry", scan["stamp"],
                     jrosbag.serialize_odometry(
                         scan["stamp"], [0.1 * i, -0.05 * i, 0.02 * i],
                         twist=[0.9, 0.0, 0.2])))
    path = str(tmp_path / f"native_{compression}.bag")
    jrosbag.write_bag(path, msgs, compression=compression)
    return path


def _bit_equal(a, b):
    assert type(a) is type(b)
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _bit_equal(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _bit_equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()  # NaN and inf bit for bit
    else:
        assert np.float64(a).tobytes() == np.float64(b).tobytes()


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_readers_bit_equal(tmp_path, compression):
    path = _bag(tmp_path, compression)
    for name, topic in (("bag_read_scans", "scan"), ("bag_read_imu", "imu"),
                        ("bag_read_odom", "odom")):
        a = getattr(native, name)(path, topic)
        b = getattr(jnative, name)(path, topic)
        assert a is not None and len(a[1]) == 5
        _bit_equal(a, b)
    ranges, _stamps, _meta = native.bag_read_scans(path, "scan")
    assert np.isnan(ranges).sum() > 0 and np.isinf(ranges).sum() > 0
    # the native decoder and the Python parser agree
    py = [p for _m, p in rosbag.parse_messages(path, {"scan"})]
    for i, parsed in enumerate(py):
        assert ranges[i].tobytes() == parsed["ranges"].tobytes()
