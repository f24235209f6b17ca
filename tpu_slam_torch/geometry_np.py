"""Batched SE(2) pose algebra on numpy arrays — the port's own copy of
``tpu_slam/geometry_np.py``, the HOST-side twin of ``geometry.py``.

Host pipelines (offline candidate/consistency math, record bookkeeping)
must not touch the device for scalar pose algebra: over a remote device
link every eager op is a dispatch, and these quantities feed host control
flow anyway. Same conventions as geometry.py: pose = (x, y, theta),
compose = "apply b in a's frame" (tf2 transform multiplication,
plicp_odometry.cc:356-370; karto::Transform, Karto.h:2890-2930).
"""

from __future__ import annotations

import numpy as np


def compose(a, b):
    """a ⊕ b for (..., 3) arrays (broadcasting)."""
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack(
        [
            a[..., 0] + c * b[..., 0] - s * b[..., 1],
            a[..., 1] + s * b[..., 0] + c * b[..., 1],
            np.arctan2(
                np.sin(a[..., 2] + b[..., 2]), np.cos(a[..., 2] + b[..., 2])
            ),
        ],
        axis=-1,
    )


def inverse(a):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack(
        [
            -(c * a[..., 0] + s * a[..., 1]),
            -(-s * a[..., 0] + c * a[..., 1]),
            -a[..., 2],
        ],
        axis=-1,
    )


def relative(a, b):
    """a⁻¹ ⊕ b: pose of b in a's frame."""
    return compose(inverse(a), b)
