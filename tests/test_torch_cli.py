"""``python -m tpu_slam_torch`` (tpu_slam_torch/cli.py) against
``python -m tpu_slam`` (tpu_slam/cli.py) on the same runs: the printed
counts equal, the ATE and final pose within 1e-3 m, the saved maps'
.yaml files equal and their cells equal; then a bag written by the port
replayed by both. The port's runs take ``--cpu``; without it, and with no
card, the port's CLI stops instead of running on the CPU."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_slam import cli as jcli
from tpu_slam.utils.map_io import load_map as jload_map
from tpu_slam_torch import cli
from tpu_slam_torch.config import ScanConfig
from tpu_slam_torch.data import rosbag
from tpu_slam_torch.data import simulator as sim
from tpu_slam_torch.utils.map_io import load_map

REPO = Path(__file__).resolve().parents[1]
_NUM = r"-?\d+(?:\.\d+)?"


def _run(main, argv, capsys):
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


def _fields(out: str) -> dict:
    """The printed lines as values: the scan count line, the accepted /
    closures / edges counts, the ATE and the final pose."""
    f = {"head": out.splitlines()[0]}
    m = re.search(r"(\d+)/(\d+) scans accepted, (\d+) loop closures, "
                  r"(\d+) edges", out)
    if m:
        f["counts"] = tuple(int(v) for v in m.groups())
    m = re.search(rf"ATE RMSE vs sim ground truth: ({_NUM}) m", out)
    if m:
        f["ate"] = float(m[1])
    m = re.search(rf"final pose: \[({_NUM}) ({_NUM}) ({_NUM})\]", out)
    f["pose"] = np.array([float(v) for v in m.groups()])
    return f


def _same_run(port_out, ref_out, keys):
    p, r = _fields(port_out), _fields(ref_out)
    assert p["head"] == r["head"]
    for k in keys:
        assert p.get(k) == r.get(k), k
    if "ate" in r:
        assert abs(p["ate"] - r["ate"]) <= 1e-3
    # printed to 1 mm: within 1e-3 after rounding
    np.testing.assert_allclose(p["pose"], r["pose"], rtol=0, atol=1.001e-3)


def test_karto_sim_with_map_matches_reference(tmp_path, capsys):
    argv = ["karto", "--sim", "--sim-scans", "20", "--save-map"]
    port = _run(cli.main, argv + [str(tmp_path / "p"), "--cpu"], capsys)
    ref = _run(jcli.main, argv + [str(tmp_path / "r")], capsys)
    _same_run(port, ref, ["counts"])
    assert (tmp_path / "p.yaml").read_text().replace("p.pgm", "") == \
        (tmp_path / "r.yaml").read_text().replace("r.pgm", "")
    # the map's cells equal: both rasterize the same corrected poses, and
    # the port's counts reproduce the reference's compiled float32 steps
    pmap, _ = load_map(str(tmp_path / "p.yaml"))
    rmap, _ = jload_map(str(tmp_path / "r.yaml"))
    np.testing.assert_array_equal(pmap, rmap)
    assert (pmap == 100).sum() > 50 and (pmap == 0).sum() > 500
    assert (tmp_path / "p_graph.png").stat().st_size > 0


def test_odometry_sim_matches_reference(capsys):
    argv = ["odometry", "--sim", "--sim-scans", "10"]
    _same_run(_run(cli.main, argv + ["--cpu"], capsys),
              _run(jcli.main, argv, capsys), [])


def _write_scans_bag(path, n=20, beams=360):
    """``n`` scans of the simulator's office loop, written by the port's
    write_bag (bz2, as the lesson bags)."""
    cfg = ScanConfig(num_beams=beams)
    traj = sim.circle_trajectory(n, radius=1.8, angular_rate=0.5)
    world = sim.office_world(seed=7, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg, noise_std=0.004, seed=2)
    msgs = []
    for t in range(n):
        raw = rosbag.serialize_laser_scan({
            "stamp": float(seq.stamps[t]) + 100.0, "frame_id": "laser",
            "angle_min": cfg.angle_min,
            "angle_max": cfg.angle_min + cfg.angle_increment * (beams - 1),
            "angle_increment": cfg.angle_increment,
            "time_increment": cfg.scan_period / beams,
            "scan_time": cfg.scan_period, "range_min": cfg.range_min,
            "range_max": cfg.range_max, "ranges": seq.ranges[t]})
        msgs.append(("laser_scan", "sensor_msgs/LaserScan",
                     float(seq.stamps[t]) + 100.0, raw))
    rosbag.write_bag(str(path), msgs, compression="bz2")
    return seq


def test_odometry_bag_written_by_the_port(tmp_path, capsys):
    bag = tmp_path / "scans.bag"
    _write_scans_bag(bag)
    argv = ["odometry", "--bag", str(bag)]
    port = _run(cli.main, argv + ["--cpu"], capsys)
    ref = _run(jcli.main, argv, capsys)
    assert port.splitlines()[0] == "20 scans, 360 beams, model=odometry"
    assert "ATE" not in port  # a bag has no ground truth
    _same_run(port, ref, [])


def test_device_of_the_run():
    parse = cli._build_parser().parse_args
    assert cli.device_of(parse(["karto", "--sim"])) == "cuda"
    assert cli.device_of(parse(["karto", "--sim", "--cpu"])) == "cpu"


def test_without_bag_or_sim_exits_2(capsys):
    assert cli.main(["odometry", "--cpu"]) == 2
    assert "need --bag FILE or --sim" in capsys.readouterr().err


def test_undistort_exits_2_naming_the_ports_modules(capsys):
    assert cli.main(["undistort", "--sim", "--sim-scans", "3", "--cpu"]) == 2
    out = capsys.readouterr().out
    assert "ops/undistort" in out and "undistort_mission" in out
    assert "examples/" not in out


def test_without_cpu_and_without_a_card_the_cli_fails():
    """``python -m tpu_slam_torch`` itself: --cpu runs, no --cpu stops
    with an error where there is no card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it")
    run = [sys.executable, "-m", "tpu_slam_torch", "features", "--sim",
           "--sim-scans", "4"]
    ok = subprocess.run(run + ["--cpu"], cwd=REPO, capture_output=True,
                        text=True, timeout=120)
    assert ok.returncode == 0, ok.stderr
    assert "corner features: mean" in ok.stdout
    bad = subprocess.run(run, cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode != 0
    assert "no CUDA device" in bad.stderr
    assert "corner features" not in bad.stdout


def test_features_count_matches_reference(capsys):
    argv = ["features", "--sim", "--sim-scans", "12"]
    port = _run(cli.main, argv + ["--cpu"], capsys)
    ref = _run(jcli.main, argv, capsys)
    line = re.compile(r"corner features: mean .* per scan")
    assert line.search(port)[0] == line.search(ref)[0]


@pytest.mark.parametrize("model", ["hector", "gmapping", "offline"])
def test_other_models_run_on_the_cpu(tmp_path, capsys, model):
    """Each other model of the CLI runs from the simulator with --cpu and
    writes its map; the run's printed lines are the reference's kinds."""
    out = _run(cli.main, [model, "--sim", "--sim-scans", "16", "--cpu",
                          "--save-map", str(tmp_path / "m")], capsys)
    assert out.splitlines()[0] == f"16 scans, 360 beams, model={model}"
    assert "done in" in out and "map saved:" in out
    assert (tmp_path / "m.pgm").exists() and (tmp_path / "m.yaml").exists()
