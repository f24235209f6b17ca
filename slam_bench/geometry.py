"""SE(2) pose algebra on numpy arrays, pose = (x, y, θ); ``compose(a, b)``
applies b in a's frame. The yardstick's own copy: the traffic generator
and the reference use it, and nothing of the program."""

from __future__ import annotations

import numpy as np


def wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def compose(a, b):
    """a ⊕ b for (..., 3) arrays (broadcasting)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([a[..., 0] + c * b[..., 0] - s * b[..., 1],
                     a[..., 1] + s * b[..., 0] + c * b[..., 1],
                     wrap(a[..., 2] + b[..., 2])], axis=-1)


def inverse(a):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack([-(c * a[..., 0] + s * a[..., 1]),
                     -(-s * a[..., 0] + c * a[..., 1]),
                     -a[..., 2]], axis=-1)


def relative(a, b):
    """a⁻¹ ⊕ b: the pose of b in a's frame."""
    return compose(inverse(a), b)


def integrate(pose0, rels):
    """The chain pose0 ⊕ rels[0] ⊕ rels[1] ⊕ … as (len(rels) + 1, 3)."""
    out = np.empty((len(rels) + 1, 3))
    out[0] = pose0
    for k, r in enumerate(rels):
        out[k + 1] = compose(out[k], r)
    return out


def ate_rmse(est, ref) -> float:
    """Absolute trajectory error RMSE (translation, m) after the best rigid
    SE(2) alignment of ``est`` onto ``ref`` (2D Procrustes)."""
    est = np.asarray(est, np.float64)
    ref = np.asarray(ref, np.float64)
    de = est[:, :2] - est[:, :2].mean(0)
    dr = ref[:, :2] - ref[:, :2].mean(0)
    th = np.arctan2((de[:, 0] * dr[:, 1] - de[:, 1] * dr[:, 0]).sum(),
                    (de * dr).sum())
    c, s = np.cos(th), np.sin(th)
    x = c * de[:, 0] - s * de[:, 1]
    y = s * de[:, 0] + c * de[:, 1]
    err = np.stack([x, y], -1) - dr
    return float(np.sqrt((err ** 2).sum(1).mean()))
