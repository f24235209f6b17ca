"""The port's rosbag module (tpu_slam_torch/data/rosbag.py) against
tpu_slam's: the same bag bytes from the same messages, each package
reading the other's bags to equal messages, and the scan loader equal on
the native decoder and on the Python parser."""

import numpy as np
import pytest

from tpu_slam.data import rosbag as jrosbag
from tpu_slam_torch import native
from tpu_slam_torch.data import rosbag


def _messages(pkg, seed=3, n=6, beams=90):
    """LaserScan (NaN and inf ranges among them), Imu and Odometry
    messages serialized by ``pkg``, from a seed."""
    rng = np.random.default_rng(seed)
    msgs = []
    for i in range(n):
        stamp = 1700000000.0 + 0.1 * i + rng.uniform(0, 0.01)
        r = rng.uniform(0.1, 11.0, beams).astype(np.float32)
        r[rng.random(beams) < 0.05] = np.nan
        r[rng.random(beams) < 0.05] = np.inf
        scan = {"stamp": stamp, "frame_id": "front_laser_link",
                "angle_min": -np.pi, "angle_max": np.pi - 2 * np.pi / beams,
                "angle_increment": 2 * np.pi / beams,
                "time_increment": 0.1 / beams, "scan_time": 0.1,
                "range_min": 0.1, "range_max": 12.0, "ranges": r,
                "intensities": rng.uniform(0, 1, beams)}
        msgs.append(("laser_scan", "sensor_msgs/LaserScan", stamp,
                     pkg.serialize_laser_scan(scan)))
        msgs.append(("imu", "sensor_msgs/Imu", stamp + 0.005,
                     pkg.serialize_imu(stamp + 0.005, rng.uniform(-3, 3),
                                       rng.normal(0, 0.1, 3))))
        msgs.append(("odom", "nav_msgs/Odometry", stamp + 0.007,
                     pkg.serialize_odometry(stamp + 0.007,
                                            rng.normal(0, 2, 3),
                                            twist=rng.normal(0, 0.5, 3))))
    return msgs


def _equal_parsed(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].tobytes() == b[k].tobytes(), k
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_write_bag_gives_the_references_bytes(tmp_path, compression):
    msgs = _messages(rosbag)
    assert msgs == _messages(jrosbag)  # the serializers agree byte for byte
    rosbag.write_bag(str(tmp_path / "port.bag"), msgs, compression)
    jrosbag.write_bag(str(tmp_path / "ref.bag"), msgs, compression)
    assert (tmp_path / "port.bag").read_bytes() == \
        (tmp_path / "ref.bag").read_bytes()


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_each_package_reads_the_others_bags(tmp_path, compression):
    msgs = _messages(rosbag, seed=5)
    port_bag, ref_bag = str(tmp_path / "p.bag"), str(tmp_path / "r.bag")
    rosbag.write_bag(port_bag, msgs, compression)
    jrosbag.write_bag(ref_bag, msgs, compression)
    for reader, path in ((rosbag, ref_bag), (jrosbag, port_bag)):
        got = list(reader.parse_messages(path))
        want = list(jrosbag.parse_messages(ref_bag))
        assert len(got) == len(msgs) == len(want)
        for (gm, gp), (wm, wp) in zip(got, want):
            assert (gm.topic, gm.msg_type, gm.stamp, gm.raw) == \
                (wm.topic, wm.msg_type, wm.stamp, wm.raw)
            _equal_parsed(gp, wp)
    # the topic filter
    assert [m.topic for m, _ in rosbag.parse_messages(ref_bag, {"imu"})] \
        == ["imu"] * 6


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("decoder", ["native", "python"])
def test_load_scan_array_on_both_decoders(tmp_path, monkeypatch, compression,
                                          decoder):
    msgs = _messages(rosbag, seed=7)
    path = str(tmp_path / "s.bag")
    rosbag.write_bag(path, msgs, compression)
    ref = jrosbag.load_scan_array(path, "laser_scan")
    if decoder == "python":
        monkeypatch.setattr(native, "bag_read_scans", lambda *a: None)
    elif not native.available():
        pytest.skip(f"native library unavailable: {native.build_error()}")
    ranges, stamps, meta = rosbag.load_scan_array(path, "laser_scan")
    assert ranges.dtype == np.float32 and ranges.shape == (6, 90)
    assert ranges.tobytes() == ref[0].tobytes()  # NaN and inf bit for bit
    assert np.isnan(ranges).any() and np.isinf(ranges).any()
    np.testing.assert_allclose(stamps, ref[1], rtol=0, atol=1e-6)
    assert meta.keys() == ref[2].keys()
    for k in meta:
        assert np.float32(meta[k]) == np.float32(ref[2][k]), k
    # the scans as written
    written = [p["ranges"] for _m, p in jrosbag.parse_messages(path)
               if _m.topic == "laser_scan"]
    assert ranges.tobytes() == np.stack(written).tobytes()


def test_rosbag_rejects_non_bag(tmp_path):
    p = tmp_path / "x.bag"
    p.write_bytes(b"not a bag")
    with pytest.raises(ValueError):
        list(rosbag.read_bag(str(p)))
    with pytest.raises(ValueError, match="unsupported compression"):
        rosbag.write_bag(str(tmp_path / "y.bag"), [], compression="lz4")
