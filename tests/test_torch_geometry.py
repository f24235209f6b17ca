"""Port parity: tpu_slam_torch.geometry and data.scan against tpu_slam's on
the same seeded numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam import geometry as geo
from tpu_slam.config import ScanConfig
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan as jax_make_scan
from tpu_slam_torch import geometry as tgeo
from tpu_slam_torch.data.scan import make_scan

from test_torch_host_copies import port_config


def _poses(seed, shape):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-3, 3, size=shape + (3,))
    p[..., 2] = rng.uniform(-np.pi, np.pi, size=shape)
    return p.astype(np.float32)


def _both(fn_name, *arrays):
    ref = np.asarray(getattr(geo, fn_name)(*(jnp.asarray(a) for a in arrays)))
    out = getattr(tgeo, fn_name)(*(torch.as_tensor(a) for a in arrays)).numpy()
    return ref, out


def _assert_pose_close(out, ref, atol_xy, atol_th):
    np.testing.assert_allclose(out[..., :2], ref[..., :2], atol=atol_xy)
    dth = np.arctan2(np.sin(out[..., 2] - ref[..., 2]),
                     np.cos(out[..., 2] - ref[..., 2]))
    np.testing.assert_allclose(dth, 0.0, atol=atol_th)


@pytest.mark.parametrize("fn_name", ["compose", "relative"])
def test_binary_ops_match_reference(fn_name):
    ref, out = _both(fn_name, _poses(0, (64,)), _poses(1, (64,)))
    _assert_pose_close(out, ref, 1e-5, 1e-6)


@pytest.mark.parametrize("fn_name", ["inverse", "log"])
def test_unary_ops_match_reference(fn_name):
    p = _poses(2, (64,))
    p[:4, 2] = [0.0, 3e-7, -5e-7, np.pi]  # the small-angle branch, and π
    ref, out = _both(fn_name, p)
    _assert_pose_close(out, ref, 1e-5, 1e-6)


def test_exp_matches_reference_and_inverts_log():
    v = _poses(6, (64,))
    v[:4, 2] = [0.0, 3e-7, -5e-7, 1.0]
    ref, out = _both("exp", v)
    _assert_pose_close(out, ref, 1e-5, 1e-6)
    back = tgeo.log(tgeo.exp(torch.as_tensor(v))).numpy()
    wrapped = v.copy()
    wrapped[:, 2] = np.arctan2(np.sin(v[:, 2]), np.cos(v[:, 2]))
    np.testing.assert_allclose(back, wrapped, atol=1e-4)


def test_matrix_forms_match_reference():
    p = _poses(7, (5, 4))
    ref, out = _both("to_matrix", p)
    assert out.shape == (5, 4, 3, 3)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    ref, out = _both("from_matrix", np.array(ref))
    _assert_pose_close(out, ref, 1e-6, 1e-6)
    _assert_pose_close(out, p, 1e-5, 1e-5)
    ref, out = _both("rot2", p[..., 2])
    assert out.shape == (5, 4, 2, 2)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_interpolate_matches_reference():
    a, b = _poses(8, (64,)), _poses(9, (64,))
    a[0, 2], b[0, 2] = 3.0, -3.0  # the short way through ±π
    alpha = np.random.default_rng(10).uniform(0, 1, 64).astype(np.float32)
    ref, out = _both("interpolate", a, b, alpha)
    _assert_pose_close(out, ref, 1e-5, 1e-6)
    assert abs(abs(float(out[0, 2])) - np.pi) < 0.3


def test_normalize_angle_matches_reference():
    th = np.random.default_rng(3).uniform(-20, 20, 256).astype(np.float32)
    ref, out = _both("normalize_angle", th)
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("batched", [False, True])
def test_apply_matches_reference(batched):
    rng = np.random.default_rng(4)
    shape = (5,) if batched else ()
    pose = _poses(5, shape)
    pts = rng.normal(0, 4, shape + (40, 2)).astype(np.float32)
    ref, out = _both("apply", pose, pts)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_compose_chain_matches_reference_and_sequential():
    # test_offline.py's sequential-composition check, with its bounds
    rng = np.random.default_rng(0)
    pose0 = rng.normal(0, 1, 3).astype(np.float32)
    rels = rng.normal(0, 0.3, (50, 3)).astype(np.float32)
    out = tgeo.compose_chain(torch.as_tensor(pose0), torch.as_tensor(rels))
    assert out.dtype == torch.float32 and out.shape == (51, 3)
    out = out.numpy()
    ref = np.asarray(geo.compose_chain(jnp.asarray(pose0), jnp.asarray(rels)))
    _assert_pose_close(out, ref, 1e-4, 1e-5)
    seq = [torch.as_tensor(pose0)]
    for k in range(50):
        seq.append(tgeo.compose(seq[-1], torch.as_tensor(rels[k])))
    _assert_pose_close(out, torch.stack(seq).numpy(), 1e-4, 1e-5)


def test_make_scan_matches_reference():
    cfg = ScanConfig(num_beams=180)
    world = sim.office_world(seed=3)
    traj = sim.circle_trajectory(6, radius=1.5)
    seq = sim.simulate_sequence(world, traj, cfg, noise_std=0.002, seed=1)
    stamps = seq.stamps.astype(np.float32)
    ref = jax_make_scan(seq.ranges, cfg, stamp=stamps)
    out = make_scan(seq.ranges, port_config(cfg), stamp=stamps, device="cpu")
    assert out.num_beams == 180
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.angles.numpy(), np.asarray(ref.angles))
    np.testing.assert_array_equal(out.stamp.numpy(), np.asarray(ref.stamp))
    np.testing.assert_allclose(out.time_increment.numpy(),
                               np.asarray(ref.time_increment), rtol=1e-7)
    v = out.valid.numpy()
    np.testing.assert_allclose(out.points().numpy()[v],
                               np.asarray(ref.points())[v], atol=1e-5)
    np.testing.assert_allclose(out.beam_times().numpy(),
                               np.asarray(ref.beam_times()), rtol=1e-7,
                               atol=1e-7)
    assert out.beam_times().shape == (6, 180)
    mask = out.valid.clone()
    mask[:, ::2] = False
    rep = out.replace(valid=mask)
    assert rep.valid is mask and rep.ranges is out.ranges
    assert out.valid.sum() > rep.valid.sum()
