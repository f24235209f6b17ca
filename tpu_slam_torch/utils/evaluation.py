"""Trajectory evaluation: ATE / RPE — the port's own copy of
``tpu_slam/utils/evaluation.py``.

The reference publishes no accuracy numbers (SURVEY §6); BASELINE.json defines
parity as ATE RMSE vs reference trajectories on the lesson workloads. These are
the standard TUM-style metrics, with an SE(2) Umeyama-style alignment.
"""

from __future__ import annotations

import numpy as np


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def align_se2(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Best rigid SE(2) transform g minimizing ||g∘est_xy − ref_xy||²."""
    pe = est[:, :2]
    pr = ref[:, :2]
    mu_e = pe.mean(axis=0)
    mu_r = pr.mean(axis=0)
    de = pe - mu_e
    dr = pr - mu_r
    # 2D Procrustes: rotation angle from cross/dot sums
    s_cos = (de * dr).sum()
    s_sin = (de[:, 0] * dr[:, 1] - de[:, 1] * dr[:, 0]).sum()
    th = np.arctan2(s_sin, s_cos)
    c, s = np.cos(th), np.sin(th)
    R = np.array([[c, -s], [s, c]])
    t = mu_r - R @ mu_e
    return np.array([t[0], t[1], th])


def transform_traj(g: np.ndarray, traj: np.ndarray) -> np.ndarray:
    c, s = np.cos(g[2]), np.sin(g[2])
    x = c * traj[:, 0] - s * traj[:, 1] + g[0]
    y = s * traj[:, 0] + c * traj[:, 1] + g[1]
    th = _wrap(traj[:, 2] + g[2])
    return np.stack([x, y, th], axis=-1)


def ate_rmse(est: np.ndarray, ref: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (translation) after optional alignment."""
    est = np.asarray(est, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert est.shape == ref.shape, (est.shape, ref.shape)
    if align:
        est = transform_traj(align_se2(est, ref), est)
    err = est[:, :2] - ref[:, :2]
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est: np.ndarray, ref: np.ndarray, delta: int = 1) -> float:
    """Relative pose error RMSE (translation) over ``delta``-step increments."""
    est = np.asarray(est, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)

    def rel(traj):
        a, b = traj[:-delta], traj[delta:]
        c, s = np.cos(a[:, 2]), np.sin(a[:, 2])
        dx = b[:, 0] - a[:, 0]
        dy = b[:, 1] - a[:, 1]
        return np.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)

    err = rel(est) - rel(ref)
    return float(np.sqrt((err**2).sum(axis=1).mean()))
