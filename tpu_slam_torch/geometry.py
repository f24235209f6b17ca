"""SE(2) geometry core — port of ``tpu_slam/geometry.py``.

Poses are tensors of shape ``(..., 3)`` holding ``(x, y, theta)``; every op
is batched over leading axes.
"""

from __future__ import annotations

import torch

__all__ = [
    "normalize_angle",
    "compose",
    "inverse",
    "relative",
    "apply",
    "compose_chain",
    "exp",
    "log",
    "to_matrix",
    "from_matrix",
    "interpolate",
    "rot2",
]


def normalize_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rot2(theta: torch.Tensor) -> torch.Tensor:
    """2x2 rotation matrices, shape (..., 2, 2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pose composition a ⊕ b: first apply b in a's frame."""
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bt = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, normalize_angle(at + bt)],
        dim=-1,
    )


def inverse(a: torch.Tensor) -> torch.Tensor:
    """Pose inverse: compose(inverse(a), a) == identity."""
    ax, ay, at = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(at), torch.sin(at)
    return torch.stack(
        [-(c * ax + s * ay), -(-s * ax + c * ay), normalize_angle(-at)], dim=-1
    )


def relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """b expressed in a's frame: compose(inverse(a), b)."""
    return compose(inverse(a), b)


def apply(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform points (..., N, 2) by pose (..., 3)."""
    t = pose[..., 2]
    c, s = torch.cos(t), torch.sin(t)
    px, py = pose[..., 0], pose[..., 1]
    if points.dim() > pose.dim():  # points carry an extra N axis
        c, s = c[..., None], s[..., None]
        px, py = px[..., None], py[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([c * x - s * y + px, s * x + c * y + py], dim=-1)


def compose_chain(pose0: torch.Tensor, rels: torch.Tensor) -> torch.Tensor:
    """Integrate a chain of relative poses: (T, 3) absolute poses with
    ``out[0] = pose0`` and ``out[k+1] = out[k] ⊕ rels[k]``.

    Closed form instead of the reference's ``associative_scan``: the
    headings are a cumulative sum, and the translations a cumulative sum of
    each step's translation rotated by the heading before it. The sums run
    in float64 (a thousand-step float32 heading sum drifts by ~1e-5 rad),
    and the result comes back in the input's dtype."""
    p0 = pose0.to(torch.float64)
    r = rels.to(torch.float64)
    zero = torch.zeros((1, 3), dtype=torch.float64, device=r.device)
    th = p0[2] + torch.cat([zero[:, 2], torch.cumsum(r[:, 2], 0)])
    c, s = torch.cos(th[:-1]), torch.sin(th[:-1])
    step = torch.stack([c * r[:, 0] - s * r[:, 1], s * r[:, 0] + c * r[:, 1]], -1)
    xy = p0[:2] + torch.cat([zero[:, :2], torch.cumsum(step, 0)])
    out = torch.cat([xy, normalize_angle(th)[:, None]], dim=-1)
    return out.to(rels.dtype)


def exp(v: torch.Tensor) -> torch.Tensor:
    """SE(2) exponential map from twist (vx, vy, omega) to pose."""
    vx, vy, w = v[..., 0], v[..., 1], v[..., 2]
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    sw, cw = torch.sin(w_safe), torch.cos(w_safe)
    a = torch.where(small, 1.0 - w * w / 6.0, sw / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - cw) / w_safe)
    return torch.stack(
        [a * vx - b * vy, b * vx + a * vy, normalize_angle(w)], dim=-1
    )


def log(p: torch.Tensor) -> torch.Tensor:
    """SE(2) logarithm map, inverse of :func:`exp`."""
    x, y, t = p[..., 0], p[..., 1], normalize_angle(p[..., 2])
    small = torch.abs(t) < 1e-6
    half = torch.where(small, torch.ones_like(t), t) / 2.0
    a = torch.where(small, 1.0 - t * t / 12.0, half / torch.tan(half))
    b = torch.where(small, t / 2.0, half)
    return torch.stack([a * x + b * y, -b * x + a * y, t], dim=-1)


def to_matrix(pose: torch.Tensor) -> torch.Tensor:
    """Pose to 3x3 homogeneous matrix, shape (..., 3, 3)."""
    c, s = torch.cos(pose[..., 2]), torch.sin(pose[..., 2])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, pose[..., 0]], dim=-1),
            torch.stack([s, c, pose[..., 1]], dim=-1),
            torch.stack([zero, zero, one], dim=-1),
        ],
        dim=-2,
    )


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3x3 homogeneous matrix to pose."""
    return torch.stack(
        [m[..., 0, 2], m[..., 1, 2], torch.atan2(m[..., 1, 0], m[..., 0, 0])],
        dim=-1,
    )


def interpolate(a: torch.Tensor, b: torch.Tensor, alpha) -> torch.Tensor:
    """Linear pose interpolation: translation lerped, heading moved along
    the wrapped angle difference."""
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    dt = normalize_angle(b[..., 2] - a[..., 2])
    return torch.stack(
        [
            a[..., 0] + alpha * dx,
            a[..., 1] + alpha * dy,
            normalize_angle(a[..., 2] + alpha * dt),
        ],
        dim=-1,
    )
