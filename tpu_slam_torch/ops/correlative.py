"""Karto correlative scan matcher — port of ``tpu_slam/ops/correlative.py``.

The re-design of ``karto::ScanMatcher`` (``Mapper.cpp:126-856``):
  * correlation grid: base-scan endpoints rasterized, then smeared as the
    int-exact separable squared-distance transform of the reference;
  * search: for every angle and every (x, y) candidate of the lattice, the
    int32 sum of grid values at the rotated beam cells (GetResponse) —
    each beam's contribution over the lattice is one strided window of
    the grid, whose start ``window_starts`` computes once;
  * the tie-averaged best pose, the positional and angular covariances.

The window sums go through ``ops/cuda/correlative_response.responses_sliced``:
on ``cuda`` the hand-written kernel ``csrc/correlative_response.cu``, on
``cpu`` its plain version ``sum_windows`` below. Everything else is plain
PyTorch, as it is XLA code in the reference.

Every function here takes a leading lane axis where the reference maps
over lanes: a chain group's C lanes share one query scan, an anchor
group's C lanes each have their own query scan and search centre, and
either group goes through one grid build, one kernel launch per pass and
one device→host read.

**The reference's float32 arithmetic.** Which cell a point lands in is
decided by rounding float32 values, so a one-ulp difference moves a beam
to another cell and changes an int32 response. The reference runs as
compiled XLA programs, and three things of XLA's CPU backend decide those
bits; the functions that index cells reproduce them:
  * a division by a constant is a product with the float32 reciprocal
    (``recip32``);
  * ``a·b ± c·d`` contracts to ``fma(a, b, ±c·d)`` (``_fma``);
  * ``cos``/``sin``/``atan2`` are glibc's ``cosf``/``sinf``/``atan2f``
    (``sincosf``, ``atan2f``: the same float64 polynomials and float32
    steps in PyTorch, so the card computes the same bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from tpu_slam_torch._dispatch import DEFAULT_DEVICE

MAX_VARIANCE = 500.0  # Mapper.cpp:36
DISTANCE_PENALTY_GAIN = 0.2  # Mapper.cpp:37
ANGLE_PENALTY_GAIN = 0.2  # Mapper.cpp:38
KT_TOLERANCE = 1e-6
GRID_OCCUPIED = 100  # GridStates_Occupied
_MIN_SQ = 0.1**2  # FindValidPoints' anchor step, squared (Mapper.cpp:786)

_F32 = torch.float32


# --- host half -----------------------------------------------------------


def kround(x: torch.Tensor) -> torch.Tensor:
    """math::Round (Math.h:87-90): round half AWAY from zero."""
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def kround_i(x: torch.Tensor) -> torch.Tensor:
    return kround(x).to(torch.int32)


def _pyround(x: float) -> int:
    """Host-side math::Round."""
    return int(math.floor(x + 0.5) if x >= 0.0 else math.ceil(x - 0.5))


def _align8(x: int) -> int:
    """math::AlignValue<8> (Math.h:244-247): the grid's row stride."""
    return (x + 7) & ~7


@dataclasses.dataclass(frozen=True)
class CorrelativeParams:
    """Static geometry of one matcher instance (ScanMatcher::Create,
    Mapper.cpp:126-173)."""

    search_size: float  # total search window (m); 0.3 front-end, 8.0 loop
    resolution: float  # correlation grid resolution
    smear_deviation: float
    range_threshold: float
    angle_offset: float  # coarse search half-window (rad)
    angle_res: float  # coarse angular step
    fine_angle_offset: float  # fine angular step (m_pFineSearchAngleOffset)
    distance_variance_penalty: float = 0.3**2
    angle_variance_penalty: float = math.radians(20.0) ** 2
    minimum_distance_penalty: float = 0.5
    minimum_angle_penalty: float = 0.9

    @property
    def n_search(self) -> int:
        # searchSpaceSideSize (Mapper.cpp:150)
        return _pyround(self.search_size / self.resolution) + 1

    @property
    def margin(self) -> int:
        # pointReadingMargin (Mapper.cpp:154)
        return int(math.ceil(self.range_threshold / self.resolution))

    @property
    def half_kernel(self) -> int:
        # GetHalfKernelSize (Mapper.h:1096-1101): 2σ, math::Round
        return _pyround(2.0 * self.smear_deviation / self.resolution)

    @property
    def grid_size(self) -> int:
        # roi + kernel border on each side (Mapper.h:928, :1016-1022)
        return self.n_search + 2 * self.margin + 2 * (self.half_kernel + 1)

    @property
    def row_stride(self) -> int:
        # m_WidthStep: 8-aligned row stride (Karto.h:4442)
        return _align8(self.grid_size)

    @property
    def center_cell(self) -> int:
        return self.grid_size // 2


def smear_kernel(params: CorrelativeParams) -> np.ndarray:
    """The reference's quantized Gaussian kernel (CalculateKernel,
    Mapper.h:1032-1094): Round(exp(-0.5 (d/σ)²)·100) in float64."""
    h = params.half_kernel
    ij = np.arange(-h, h + 1, dtype=np.float64)
    dx, dy = np.meshgrid(ij, ij, indexing="ij")
    d = np.hypot(dx * params.resolution, dy * params.resolution)
    z = np.exp(-0.5 * (d / params.smear_deviation) ** 2)
    return np.floor(z * GRID_OCCUPIED + 0.5).astype(np.int32)


def smear_lut(params: CorrelativeParams) -> np.ndarray:
    """Kernel value as a function of squared cell distance d² = i²+j²:
    LUT[d²] = Round(100·exp(-0.5·d²·(res/σ)²)). The kernel is radially
    monotone, so the max over overlapping SmearPoint patches is LUT[min d²
    to an occupied cell]."""
    h = params.half_kernel
    d2 = np.arange(2 * h * h + 1, dtype=np.float64)
    z = np.exp(-0.5 * d2 * (params.resolution / params.smear_deviation) ** 2)
    return np.floor(z * GRID_OCCUPIED + 0.5).astype(np.int32)


# --- the reference's float32 arithmetic ------------------------------------


def recip32(x: float) -> float:
    """float32(1 / float32(x)): XLA multiplies by this where the reference
    divides by the constant ``x``."""
    return float(np.float32(1.0) / np.float32(x))


def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """a·b + c rounded once to float32. The product of two float32 values
    is exact in float64, so only the float64 sum rounds before the final
    rounding (a double rounding that can differ from a true fma only when
    the float64 sum lands exactly on a float32 midpoint)."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    return (a.double() * b + c.double()).to(_F32)


# glibc's sinf/cosf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c, sincosf.h
# and sincosf_data.c): the argument is reduced by π/2 in float64 and a
# float64 polynomial is rounded to float32
_SC_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2/π · 2^24
_SC_HPI = float.fromhex("0x1.921fb54442d18p+0")  # π/2
_SC_C = tuple(float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SC_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))


def sincosf(theta: torch.Tensor):
    """(sin, cos) of float32 angles, bit for bit as glibc's ``sinf`` and
    ``cosf`` give them for |θ| < 120 (the angles here stay within ±5)."""
    x = theta.double()
    n = torch.div((x * _SC_HPI_INV).to(torch.int64) + 0x800000, 1 << 24,
                  rounding_mode="floor")
    r = x - n.double() * _SC_HPI
    # the sign of quadrants 0..3 is (1, -1, -1, 1) on the reduced argument
    r = torch.where(((n + 1) & 2) == 0, r, -r)
    x2 = r * r
    x3 = r * x2
    sp = (r + x3 * _SC_S[0]) + (x3 * x2) * (_SC_S[1] + x2 * _SC_S[2])
    x4 = x2 * x2
    c0, c1, c2, c3, c4 = _SC_C
    cp = ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)
    cp = torch.where((n & 2) == 0, cp, -cp)  # the negated cosine table
    even = (n & 1) == 0
    s = torch.where(even, sp, cp).to(_F32)
    c = torch.where(even, cp, sp).to(_F32)
    tiny = theta.abs() < 2.0**-12
    return (torch.where(tiny, theta, s),
            torch.where(tiny, torch.ones_like(c), c))


# glibc's atan2f/atanf (e_atan2f.c, s_atanf.c): float32 throughout
_AT = tuple(float(np.float32(v)) for v in (
    3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01,
    -1.1111110449e-01, 9.0908870101e-02, -7.6918758452e-02,
    6.6610731184e-02, -5.8335702866e-02, 4.9768779427e-02,
    -3.6531571299e-02, 1.6285819933e-02))
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01,
            1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08,
            7.5497894159e-08)
_PI = float(np.float32(3.1415927410e+00))
_PI_LO = float(np.float32(-8.7422776573e-08))
_PI_O_2 = float(np.float32(1.5707963705e+00))


def _atanf(x: torch.Tensor) -> torch.Tensor:
    hx = x.view(torch.int32)
    ix = hx & 0x7FFFFFFF
    a = x.abs()
    ids = ((ix >= 0x3EE00000).to(torch.int64) + (ix >= 0x3F300000)
           + (ix >= 0x3F980000) + (ix >= 0x401C0000)) - 1
    r = torch.where(ids == 0, (2.0 * a - 1.0) / (2.0 + a), x)
    r = torch.where(ids == 1, (a - 1.0) / (a + 1.0), r)
    r = torch.where(ids == 2, (a - 1.5) / (1.5 * a + 1.0), r)
    r = torch.where(ids == 3, torch.div(torch.full_like(a, -1.0), a), r)
    z = r * r
    w = z * z
    s1 = z * (_AT[0] + w * (_AT[2] + w * (_AT[4] + w * (_AT[6] + w * (
        _AT[8] + w * _AT[10])))))
    s2 = w * (_AT[1] + w * (_AT[3] + w * (_AT[5] + w * (_AT[7]
                                                      + w * _AT[9]))))
    small = r - r * (s1 + s2)
    k = ids.clamp(min=0)
    hi = torch.as_tensor(_ATAN_HI, dtype=_F32, device=x.device)[k]
    lo = torch.as_tensor(_ATAN_LO, dtype=_F32, device=x.device)[k]
    big = hi - ((r * (s1 + s2) - lo) - r)
    big = torch.where(hx < 0, -big, big)
    huge = torch.where(hx < 0, -(hi + lo), hi + lo)  # |x| ≥ 2^25
    out = torch.where(ids < 0, small, big)
    return torch.where(ix >= 0x4C000000, huge, out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """float32 atan2, bit for bit as glibc's ``atan2f`` gives it for finite
    arguments."""
    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hy >> 31) & 1) | ((hx >> 30) & 2)  # 2·sign(x) + sign(y)
    q = torch.where(ix == 0, torch.ones_like(x), x)
    z = _atanf((y / q).abs())
    k = (iy - ix) >> 23
    z = torch.where(k > 60, torch.full_like(z, _PI_O_2 + 0.5 * _PI_LO), z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    out = torch.where(m == 0, z, -z)
    out = torch.where(m == 2, _PI - (z - _PI_LO), out)
    out = torch.where(m == 3, (z - _PI_LO) - _PI, out)
    out = torch.where(hx == 0x3F800000, _atanf(y), out)
    # y = ±0: ±0 for x > 0, ±π for x < 0; x = ±0: ±π/2 by the sign of y
    zero_y = torch.where(m == 2, torch.full_like(y, _PI), y)
    zero_y = torch.where(m == 3, torch.full_like(y, -_PI), zero_y)
    zero_x = torch.where(hy < 0, torch.full_like(y, -_PI_O_2),
                         torch.full_like(y, _PI_O_2))
    out = torch.where(ix == 0, zero_x, out)
    out = torch.where(iy == 0, zero_y, out)
    return torch.where(torch.isnan(x) | torch.isnan(y), x + y, out)


def apply_pose(pose: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """``geometry.apply`` in the reference's float32 arithmetic: points
    (..., N, 2) by pose (..., 3)."""
    s, c = sincosf(pose[..., 2])
    s, c = s[..., None], c[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.stack([_fma(c, x, -(s * y)) + pose[..., 0, None],
                        _fma(s, x, c * y) + pose[..., 1, None]], dim=-1)


def angle_ladder(theta: torch.Tensor, angle_offset: float,
                  angle_res: float, n: int) -> torch.Tensor:
    """The search headings θ − angle_offset + i·angle_res, i < n, (..., n)
    for θ (..., 1): the product and the sum fused, as XLA fuses them where
    the reference uses the headings."""
    steps = torch.arange(n, dtype=_F32, device=theta.device)
    return _fma(steps, float(np.float32(angle_res)), theta - angle_offset)


def _rotate_cells(angles: torch.Tensor, pts_cells: torch.Tensor):
    """Rotated beam offsets (rx, ry), angles (..., A) × points (N, 2), or
    (..., N, 2) a lane, → (..., A, N) each, as the reference's response
    paths compute them."""
    s, c = sincosf(angles)
    s, c = s[..., None], c[..., None]
    px, py = pts_cells[..., None, :, 0], pts_cells[..., None, :, 1]
    return _fma(c, px, -(s * py)), _fma(s, px, c * py)


# --- device half ---------------------------------------------------------


def build_correlation_grid(
    params: CorrelativeParams,
    center_xy: torch.Tensor,
    pts: torch.Tensor,
    valid: torch.Tensor,
) -> torch.Tensor:
    """Rasterize base-scan world points around ``center_xy`` and smear.

    pts: (..., K, 2) world points, valid: (..., K); ``center_xy`` (2,), or
    one a grid (L, 2) for L grids. Returns the int32 grid
    (..., G, W8), W8 the 8-aligned row stride (right-padded with zeros),
    values 0..100: LUT[min d² to an occupied cell] by the separable
    two-pass squared-distance transform, int-exact like the reference.
    XLA drops the out-of-bounds scatter (``mode="drop"``); here those
    points are written to a spare cell past the grids, which is cut off."""
    g = params.grid_size
    w8 = params.row_stride
    c = params.center_cell
    h = params.half_kernel
    dev = pts.device
    lead = pts.shape[:-2]
    L = int(np.prod(lead)) if lead else 1
    pts = pts.reshape(L, -1, 2)
    valid = valid.reshape(L, -1)
    lut = torch.as_tensor(smear_lut(params), device=dev)
    inf = 2 * h * h + 1

    if center_xy.dim() > 1:
        center_xy = center_xy.reshape(L, 1, 2)
    rel = (pts - center_xy) * recip32(params.resolution)
    ix = kround_i(rel[..., 0]) + c
    iy = kround_i(rel[..., 1]) + c
    # ROI bounds check of AddScan (Mapper.cpp:723-730)
    inb = (ix >= h + 1) & (ix < g - h - 1) & (iy >= h + 1) & (iy < g - h - 1)
    lane = torch.arange(L, device=dev)[:, None] * (g * w8)
    spare = L * g * w8
    flat = torch.where(inb & valid, lane + iy * w8 + ix,
                       torch.full_like(lane + ix, spare))
    occ = torch.zeros(spare + 1, dtype=torch.bool, device=dev)
    occ[flat.reshape(-1).to(torch.int64)] = True
    occ = occ[:spare].view(L, g, w8)

    # pass 1: per-row min dx² to an occupied cell within |dx| ≤ h
    pad = torch.nn.functional.pad(occ, (h, h))
    rowd2 = torch.full((L, g, w8), inf, dtype=torch.int32, device=dev)
    for j in range(2 * h + 1):
        rowd2 = torch.where(pad[:, :, j:j + w8],
                            torch.clamp(rowd2, max=(j - h) * (j - h)), rowd2)
    # pass 2: min over |dy| ≤ h of rowd2 + dy²
    pad2 = torch.nn.functional.pad(rowd2, (0, 0, h, h), value=inf)
    d2 = torch.full((L, g, w8), inf, dtype=torch.int32, device=dev)
    for i in range(2 * h + 1):
        d2 = torch.minimum(d2, pad2[:, i:i + g, :] + (i - h) * (i - h))
    vals = lut[torch.clamp(d2, 0, 2 * h * h).to(torch.int64)]
    out = torch.where(d2 <= 2 * h * h, vals, 0).to(torch.int32)
    return out.view(*lead, g, w8)


class CorrelateResult(NamedTuple):
    best_pose: torch.Tensor  # (..., 3) tie-averaged best pose (world)
    best_response: torch.Tensor  # (...)
    search_probs: torch.Tensor  # (..., nY, nX) per-cell max response
    angle_responses: torch.Tensor  # (..., nA) responses at the best cell


def _responses_for_angles(grid_flat, g: int, w8: int, pts_local, beam_valid,
                          angles, cand_cells_flat,
                          element_budget: int = 24_000_000):
    """Numerators (C, nA, nCand) by random gathers, for candidate cells
    that are not a lattice: grid_flat (C, g·w8), angles (C, nA),
    cand_cells_flat (C, nCand). The reference's IsUpTo check of
    GetResponse (Mapper.cpp:843-848), row wrap included."""
    C, nA = angles.shape
    nC = cand_cells_flat.shape[-1]
    N = pts_local.shape[-2]
    beam_valid = beam_valid.expand(C, N)[:, None, None, :]
    size = g * w8
    rx, ry = _rotate_cells(angles, pts_local)
    off = kround_i(ry) * w8 + kround_i(rx)  # (C, nA, N)
    per = max(1, element_budget // max(nC * N, 1))
    out = []
    for a0 in range(0, nA, per):
        idx = cand_cells_flat[:, None, :, None] + off[:, a0:a0 + per, None, :]
        ok = beam_valid & (idx >= 0) & (idx < size)
        flat = torch.clamp(idx, 0, size - 1).to(torch.int64)
        vals = torch.gather(grid_flat, 1, flat.reshape(C, -1)).view(idx.shape)
        vals = torch.where(ok, vals.to(torch.int32), 0)
        out.append(vals.sum(-1, dtype=torch.int32))
    return torch.cat(out, 1)


def _lattice_stride(x_offsets: np.ndarray, y_offsets: np.ndarray,
                    resolution: float) -> int | None:
    """Integer cell stride of the candidate lattice, or None if the offsets
    are not a uniform lattice whose step is a whole number of grid cells on
    both axes. Tolerances absorb float32 jitter in ``-half + i·step``."""
    strides = []
    for off in (x_offsets, y_offsets):
        off = np.asarray(off, np.float64)
        if len(off) < 2:
            strides.append(1)
            continue
        k = (off[-1] - off[0]) / (len(off) - 1) / resolution
        ki = int(round(k))
        if ki < 1 or abs(k - ki) > 1e-3:
            return None
        lattice = off[0] + np.arange(len(off)) * ki * resolution
        if np.max(np.abs(off - lattice)) > 0.05 * resolution:
            return None
        strides.append(ki)
    if strides[0] != strides[1]:
        return None
    return strides[0]


def window_starts(pts_cells, beam_valid, angles, cand0_xy, H: int, W: int,
                  n_x: int, n_y: int, stride: int):
    """Each beam's window start over the candidate lattice, (ys, xs) int32
    (C, A, N): the first candidate's cell plus the beam's rotated cell
    offset (math::Round of the rotated point, GridIndexLookup::
    ComputeOffsets, Karto.h:6455-6500), as ``jax.lax.dynamic_slice``
    takes it in the reference's ``_responses_sliced``: a negative start
    counts from the end of the axis (start + dim), then the start is
    clamped to [0, dim − span]. A window that would leave the grid is
    shifted, not masked. (The reference's Pallas kernel clamps without the
    wrap; the two differ only for a negative start, ROADMAP queue 3.)
    angles (C, A), cand0_xy (C, 2) [x, y]. Invalid beams (whose points may
    be ±inf or NaN) get offset 0. Points are shared, (N, 2), or a lane's
    own, (C, N, 2); flags (N,) or (C, N) are taken as (C, N)."""
    rx, ry = _rotate_cells(angles, pts_cells)
    beam_valid = beam_valid.expand(rx.shape[0], rx.shape[-1])[:, None]
    starts = []
    for k, (r, dim, n) in enumerate(((ry, H, n_y), (rx, W, n_x))):
        o = torch.where(beam_valid, kround(r), 0.0).to(torch.int32)
        s = cand0_xy[:, 1 - k, None, None] + o
        s = torch.where(s < 0, s + dim, s)
        starts.append(torch.clamp(s, 0, dim - (n - 1) * stride - 1)
                      .to(torch.int32).contiguous())
    return tuple(starts)


def sum_windows(grid, ys, xs, beam_valid, n_x: int, n_y: int, stride: int):
    """The plain version of the ``correlative_response`` kernel: for every
    lane c, angle a and candidate (y, x), the sum over beams n of
    grid[c, ys[c,a,n] + y·stride, xs[c,a,n] + x·stride] · valid[c, n].
    grid (C, H, W) of any integer type, ys/xs (C, A, N) int32, beam_valid
    (C, N) bool (a lane's own flags, or one scan's expanded); returns
    (C, A, nY·nX) int32. Starts are clamped as the kernel clamps them (a
    no-op for ``window_starts``' output)."""
    C, H, W = grid.shape
    A, N = ys.shape[1:]
    span_x = (n_x - 1) * stride + 1
    span_y = (n_y - 1) * stride + 1
    dev = grid.device
    flat = grid.reshape(-1)
    lat = ((torch.arange(n_y, device=dev) * (stride * W))[:, None]
           + torch.arange(n_x, device=dev) * stride).reshape(-1)
    base = (torch.clamp(ys.to(torch.int64), 0, H - span_y) * W
            + torch.clamp(xs.to(torch.int64), 0, W - span_x)
            + (torch.arange(C, device=dev) * (H * W))[:, None, None])
    base = base.reshape(C * A, N)
    keep = beam_valid.expand(C, N)[:, None].expand(C, A, N).reshape(
        C * A, N, 1).to(torch.int32)
    # (rows, beams, candidates) gathered at once: ~8 M elements a step
    rows = max(1, 8_000_000 // max(N * n_x * n_y, 1))
    out = torch.empty((C * A, n_y * n_x), dtype=torch.int32, device=dev)
    for r0 in range(0, C * A, rows):
        idx = base[r0:r0 + rows, :, None] + lat  # (rows, N, nCand)
        vals = flat[idx].to(torch.int32) * keep[r0:r0 + rows]
        out[r0:r0 + rows] = vals.sum(1, dtype=torch.int32)
    return out.view(C, A, n_y * n_x)


def _responses_sliced(grid, pts_cells, beam_valid, angles, cand0_xy,
                      n_x: int, n_y: int, stride: int):
    """The reference's ``_responses_sliced``: numerators (A, nY·nX) int32
    of one grid (H, W), or (C, A, nY·nX) of grids (C, H, W) with angles
    (C, A) and cand0_xy (C, 2). ``window_starts`` then ``sum_windows``."""
    lanes = grid.dim() == 3
    if not lanes:
        grid, angles, cand0_xy = grid[None], angles[None], cand0_xy[None]
    H, W = grid.shape[-2:]
    ys, xs = window_starts(pts_cells, beam_valid, angles, cand0_xy, H, W,
                           n_x, n_y, stride)
    out = sum_windows(grid, ys, xs, beam_valid, n_x, n_y, stride)
    return out if lanes else out[0]


def lattice_starts(params: CorrelativeParams, grid_center_xy, search_center,
                   pts_cells, beam_valid, angles, x_offsets, y_offsets,
                   stride: int):
    """The window starts of a lattice search (``window_starts``): the first
    candidate's cell, from search centers (C, 3), and the beams' rotated
    offsets at headings (C, A). The offsets are integer multiples of the
    resolution, so only the first candidate needs rounding."""
    dev = search_center.device
    first = torch.as_tensor(np.asarray([x_offsets[0], y_offsets[0]],
                                       np.float32), device=dev)
    rel0 = ((search_center[:, :2] + first) - grid_center_xy) * recip32(
        params.resolution)
    cand0 = kround_i(rel0) + params.center_cell  # (C, 2) [x, y]
    return window_starts(pts_cells, beam_valid, angles, cand0,
                         params.grid_size, params.row_stride,
                         len(x_offsets), len(y_offsets), stride)


def _lanes(x: torch.Tensor, dims: int) -> torch.Tensor:
    return x if x.dim() > dims else x[None]


def correlate_scan(
    grid: torch.Tensor,
    params: CorrelativeParams,
    grid_center_xy: torch.Tensor,
    search_center: torch.Tensor,
    scan_pts_laser: torch.Tensor,
    beam_valid: torch.Tensor,
    x_offsets: np.ndarray,
    y_offsets: np.ndarray,
    n_angles: int,
    angle_offset: float,
    angle_res: float,
    do_penalize: bool,
) -> CorrelateResult:
    """One CorrelateScan pass (Mapper.cpp:309-523) over grids (G, W8) or
    (C, G, W8) (int32 or uint8) with search centers (3,) or (C, 3), grid
    centers (2,) or (C, 2).

    Candidate poses are center + (dx, dy) over the static offsets and
    headings center.θ − angle_offset + i·angle_res. scan_pts_laser: (N, 2)
    beam endpoints in the LASER frame, ALL beams, or (C, N, 2) a lane's own
    scan; NaN/inf beams carry beam_valid=False ((N,) or (C, N)). The
    numerators come from the response kernel (or its plain version on the
    CPU) when the offsets form a lattice."""
    from tpu_slam_torch.ops.cuda.correlative_response import responses_sliced

    lanes = grid.dim() == 3
    grid = _lanes(grid, 2)
    search_center = _lanes(search_center, 1)
    p = params
    g, w8 = p.grid_size, p.row_stride
    C = grid.shape[0]
    beam_valid = beam_valid.contiguous().expand(C, scan_pts_laser.shape[-2])
    dt, dev = scan_pts_laser.dtype, grid.device
    nX, nY = len(x_offsets), len(y_offsets)
    xo = torch.as_tensor(np.asarray(x_offsets, np.float32), device=dev)
    yo = torch.as_tensor(np.asarray(y_offsets, np.float32), device=dev)
    angles = angle_ladder(search_center[:, 2:3], angle_offset, angle_res,
                           n_angles)  # (C, nA)
    pts_cells = scan_pts_laser * recip32(p.resolution)

    stride = _lattice_stride(x_offsets, y_offsets, p.resolution)
    if stride is not None:
        ys, xs = lattice_starts(p, grid_center_xy, search_center, pts_cells,
                                beam_valid, angles, x_offsets, y_offsets,
                                stride)
        grid8 = grid if grid.dtype == torch.uint8 else grid.to(torch.uint8)
        nums = responses_sliced(grid8.contiguous(), ys, xs, beam_valid, nX,
                                nY, stride)
    else:
        cand = torch.stack(torch.meshgrid(yo, xo, indexing="ij"), -1)
        cand_world = search_center[:, None, None, :2] + cand.flip(-1)
        gc = (grid_center_xy if grid_center_xy.dim() == 1
              else grid_center_xy[:, None, None, :])
        rel = (cand_world - gc) * recip32(p.resolution)
        cix = kround_i(rel[..., 0]) + p.center_cell
        ciy = kround_i(rel[..., 1]) + p.center_cell
        nums = _responses_for_angles(
            grid.reshape(C, -1), g, w8, pts_cells, beam_valid, angles,
            (ciy * w8 + cix).reshape(C, -1))
    # normalized by the TOTAL reading count, NaN beams included (GetResponse
    # nPoints, Mapper.cpp:852-853)
    n_beams = scan_pts_laser.shape[-2]
    resp = nums.to(dt) * recip32(GRID_OCCUPIED * n_beams)
    resp = resp.view(C, n_angles, nY, nX)

    if do_penalize:
        sq_dist = xo[None, :] ** 2 + yo[:, None] ** 2
        dist_pen = (1.0 - DISTANCE_PENALTY_GAIN * sq_dist
                    / p.distance_variance_penalty)
        dist_pen = torch.clamp(dist_pen, min=p.minimum_distance_penalty)
        dth = angles - search_center[:, 2:3]
        ang_pen = 1.0 - ANGLE_PENALTY_GAIN * dth**2 / p.angle_variance_penalty
        ang_pen = torch.clamp(ang_pen, min=p.minimum_angle_penalty)
        pen = dist_pen[None, None] * ang_pen[:, :, None, None]
        # Mapper.cpp:399-414 penalizes only a nonzero response
        resp = torch.where(resp > 0.0, resp * pen, resp)

    best = resp.amax(dim=(1, 2, 3))
    tie = (resp >= (best - KT_TOLERANCE)[:, None, None, None]).to(dt)
    cnt = tie.sum(dim=(1, 2, 3))
    sa, ca = sincosf(angles)
    ax = (tie * (search_center[:, 0, None] + xo)[:, None, None, :]).sum(
        dim=(1, 2, 3)) / cnt
    ay = (tie * (search_center[:, 1, None] + yo)[:, None, :, None]).sum(
        dim=(1, 2, 3)) / cnt
    acos = (tie * ca[:, :, None, None]).sum(dim=(1, 2, 3)) / cnt
    asin = (tie * sa[:, :, None, None]).sum(dim=(1, 2, 3)) / cnt
    best_pose = torch.stack([ax, ay, atan2f(asin, acos)], -1)

    search_probs = resp.amax(dim=1)
    # angle responses at the best (tie-averaged) position's cell
    brel = (best_pose[:, :2] - grid_center_xy) * recip32(p.resolution)
    bflat = ((kround_i(brel[:, 1]) + p.center_cell) * w8
             + kround_i(brel[:, 0]) + p.center_cell)
    rx, ry = _rotate_cells(angles, pts_cells)
    bv = beam_valid[:, None]
    idx = (bflat[:, None, None] + torch.where(
        bv, kround_i(ry) * w8 + kround_i(rx), 0))  # (C, nA, N)
    ok = bv & (idx >= 0) & (idx < g * w8)
    vals = torch.gather(grid.reshape(C, -1), 1,
                        torch.clamp(idx, 0, g * w8 - 1).to(torch.int64)
                        .view(C, -1)).view(idx.shape)
    angle_responses = (torch.where(ok, vals.to(torch.int32), 0)
                       .sum(-1, dtype=torch.int32).to(dt)
                       * recip32(GRID_OCCUPIED * n_beams))
    out = CorrelateResult(best_pose, best, search_probs, angle_responses)
    return out if lanes else CorrelateResult(*(t[0] for t in out))


def positional_covariance(
    params: CorrelativeParams,
    best_pose: torch.Tensor,
    best_response: torch.Tensor,
    search_center: torch.Tensor,
    x_offsets: np.ndarray,
    y_offsets: np.ndarray,
    angle_res: float,
    search_probs: torch.Tensor,
) -> torch.Tensor:
    """ComputePositionalCovariance (Mapper.cpp:535-633), over any leading
    lane axes: best_pose (..., 3), best_response (...), search_probs
    (..., nY, nX); returns (..., 3, 3)."""
    dt, dev = best_pose.dtype, best_pose.device
    xo = torch.as_tensor(np.asarray(x_offsets, np.float32), device=dev)
    yo = torch.as_tensor(np.asarray(y_offsets, np.float32), device=dev)
    dx = (best_pose[..., 0] - search_center[..., 0])[..., None, None]
    dy = (best_pose[..., 1] - search_center[..., 1])[..., None, None]
    keep = search_probs >= (best_response - 0.1)[..., None, None]
    w = torch.where(keep, search_probs, 0.0)
    norm = w.sum(dim=(-2, -1))
    X = xo[None, :] - dx
    Y = yo[:, None] - dy
    den = torch.clamp(norm, min=KT_TOLERANCE)
    vxx = (X**2 * w).sum(dim=(-2, -1)) / den
    vxy = (X * Y * w).sum(dim=(-2, -1)) / den
    vyy = (Y**2 * w).sum(dim=(-2, -1)) / den
    res_step = (x_offsets[1] - x_offsets[0] if len(x_offsets) > 1
                else params.resolution)
    min_v = float(0.1 * res_step**2)
    vxx = torch.clamp(vxx, min=min_v)
    vyy = torch.clamp(vyy, min=min_v)
    mult = 1.0 / torch.clamp(best_response, min=KT_TOLERANCE)
    vth = 4.0 * angle_res**2
    # zero-variance fallback (:622-633): DoubleEqual(cov_ii, 0) → MAX
    cxx = torch.where((vxx * mult).abs() <= KT_TOLERANCE,
                      torch.full_like(vxx, MAX_VARIANCE), vxx * mult)
    cyy = torch.where((vyy * mult).abs() <= KT_TOLERANCE,
                      torch.full_like(vyy, MAX_VARIANCE), vyy * mult)
    zero = torch.zeros_like(cxx)
    cov = torch.stack([
        torch.stack([cxx, vxy * mult, zero], -1),
        torch.stack([vxy * mult, cyy, zero], -1),
        torch.stack([zero, zero, torch.full_like(cxx, vth)], -1),
    ], -2)
    eye = torch.eye(3, dtype=dt, device=dev)
    # norm ≤ tol: the reference leaves the identity (:597-618)
    cov = torch.where((norm > KT_TOLERANCE)[..., None, None], cov, eye)
    # bestResponse < tol → MAX_VARIANCE early-out (:545-556)
    big = torch.as_tensor(
        np.diag([MAX_VARIANCE, MAX_VARIANCE, 4.0 * angle_res**2]),
        dtype=dt, device=dev)
    return torch.where((best_response < KT_TOLERANCE)[..., None, None], big,
                       cov)


def angular_covariance(
    best_pose: torch.Tensor,
    best_response: torch.Tensor,
    search_center: torch.Tensor,
    angle_offset: float,
    angle_res: float,
    angle_responses: torch.Tensor,
    cov: torch.Tensor,
) -> torch.Tensor:
    """ComputeAngularCovariance (Mapper.cpp:641-693); overwrites cov[2,2].
    Any leading lane axes."""
    angles = angle_ladder(search_center[..., 2:3], angle_offset, angle_res,
                           angle_responses.shape[-1])
    d = best_pose[..., 2] - search_center[..., 2]
    sd, cd = sincosf(d)
    best_angle = atan2f(sd, cd) + search_center[..., 2]
    keep = angle_responses >= (best_response - 0.1)[..., None]
    w = torch.where(keep, angle_responses, 0.0)
    norm = w.sum(-1)
    acc = ((angles - best_angle[..., None]) ** 2 * w).sum(-1)
    # the res² floor applies BEFORE the norm division (Mapper.cpp:679-686)
    acc = torch.where(acc < KT_TOLERANCE, torch.full_like(acc, angle_res**2),
                      acc)
    vth = torch.where(norm > KT_TOLERANCE,
                      acc / torch.clamp(norm, min=KT_TOLERANCE),
                      torch.full_like(acc, 1000.0 * angle_res**2))
    cov = cov.clone()
    cov[..., 2, 2] = vth
    return cov


def find_valid_points(pts: torch.Tensor, valid: torch.Tensor,
                      viewpoint: torch.Tensor) -> torch.Tensor:
    """FindValidPoints (Mapper.cpp:765-813) over leading axes: pts
    (..., N, 2), valid (..., N), viewpoint (2,) or any (..., 2) that
    broadcasts against the leading axes. The walk keeps a trailing
    anchor; when a point lies more than 10 cm from it, the run of points
    since the anchor is kept iff the determinant test at the new anchor
    says the surface faces the viewpoint (ss ≥ 0). The run after the last
    anchor is never kept.

    ``pts`` are the RAW endpoints: the walk has no validity gating, so
    ±inf points ARE anchors (d² = inf > 0.01) whose NaN determinants keep
    their run, and NaN points never are; only NaN points are skipped when
    picking the first anchor. IEEE semantics give this. The forward walk
    is sequential in the points (one step per beam, every scan of the
    batch at once); the backward pass, which gives each point the verdict
    of the first anchor after it, is a reverse cumulative min."""
    lead = pts.shape[:-2]
    N = pts.shape[-2]
    dev = pts.device
    P = pts.reshape(-1, N, 2)
    B = P.shape[0]
    vp = torch.broadcast_to(viewpoint.to(P.dtype),
                            (*lead, 2)).reshape(B, 1, 2)
    vx, vy = vp[..., 0], vp[..., 1]
    # a point p as the anchor: its (x, y, a, b, c) with the reference's
    # coefficients (Mapper.cpp:792-800)
    cand = torch.stack([
        P[..., 0], P[..., 1], vy - P[..., 1], P[..., 0] - vx,
        P[..., 1] * vx - P[..., 0] * vy], -1)  # (B, N, 5)
    not_nan = ~torch.isnan(P).any(-1)
    first = torch.argmax(not_nan.to(torch.uint8), dim=1)
    state = cand[torch.arange(B, device=dev), first]  # (B, 5)
    # point-major copies, so each step reads and writes contiguous rows
    PT = P.transpose(0, 1).contiguous()
    cand = cand.transpose(0, 1).contiguous()
    d2 = torch.empty((N, B), dtype=P.dtype, device=dev)
    ss = torch.empty((N, B), dtype=P.dtype, device=dev)
    for n in range(N):
        p = PT[n]
        diff = state[:, :2] - p
        torch.sum(diff * diff, -1, out=d2[n])
        torch.sum(p * state[:, 2:4], -1, out=ss[n])
        ss[n] += state[:, 4]
        state = torch.where((d2[n] > _MIN_SQ)[:, None], cand[n], state)
    moved = (d2 > _MIN_SQ).T
    ok = ~(ss < 0.0).T  # a NaN ss keeps the run, as the C++ does
    # the verdict of the first anchor strictly after each point
    at = torch.where(moved, torch.arange(N, device=dev), N)
    nxt = torch.flip(torch.cummin(torch.flip(at, [1]), 1).values, [1])
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), N, device=dev)], 1)
    ok_pad = torch.cat([ok, torch.zeros((B, 1), dtype=torch.bool,
                                        device=dev)], 1)
    keep = torch.gather(ok_pad, 1, nxt)
    return valid & keep.view(*lead, N)


class MatchResult(NamedTuple):
    pose: torch.Tensor  # (..., 3) best pose (world)
    response: torch.Tensor  # (...) in [0, 1]
    covariance: torch.Tensor  # (..., 3, 3)


def to_host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


class CorrelativeMatcher:
    """MatchScan orchestration (Mapper.cpp:184-291): coarse correlate →
    optional response expansion (±20°, ±40°, ±60° widening, :242-272) →
    fine correlate (doRefineMatch) → covariances.

    ``device`` is where the host-data entry point ``match_chains`` puts
    its tensors; the other entry points run where their tensors are."""

    def __init__(self, params: CorrelativeParams,
                 use_response_expansion=True, device=DEFAULT_DEVICE):
        self.p = params
        self.use_response_expansion = use_response_expansion
        self.device = torch.device(device)
        p = params
        res = p.resolution
        # coarse: half the cells (2×res step) over the search window
        # (MatchScan, Mapper.cpp:228-236)
        half = 0.5 * (p.n_search - 1) * res
        n_coarse = int(round(half * 2.0 / (2.0 * res))) + 1
        self.coarse_x = np.asarray(
            [-half + i * 2.0 * res for i in range(n_coarse)], np.float32)
        self.coarse_y = self.coarse_x.copy()
        # fine: ±coarse_step/2 at res step → 3 offsets per axis (:275-281)
        self.fine_x = np.asarray([-res, 0.0, res], np.float32)
        self.fine_y = self.fine_x.copy()
        self.n_angles_coarse = (
            int(round(p.angle_offset * 2.0 / p.angle_res)) + 1)
        # fine pass: angle window ±coarse_res/2 at fine_angle_offset step
        self.fine_angle_offset = 0.5 * p.angle_res
        self.n_angles_fine = (
            int(round(self.fine_angle_offset * 2.0 / p.fine_angle_offset)) + 1)

    def _match_fn(self, angle_offset: float, do_penalize: bool,
                  do_fine: bool):
        """The match program: grid build → coarse correlate → positional
        covariance → fine correlate → angular covariance, over C lanes of
        base points (C, K, 2). The lanes share the query scan (N, 2), its
        flags (N,) and its pose (3,), or each has its own: (C, N, 2),
        (C, N), (C, 3); each lane's grid is centred on its pose."""
        p = self.p
        n_ang = int(round(angle_offset * 2.0 / p.angle_res)) + 1

        def f(base_pts, base_valid, pts, bvalid, scan_pose):
            C = base_pts.shape[0]
            center = scan_pose.expand(C, 3)
            grid_center = center[:, :2]
            grid = build_correlation_grid(p, grid_center, base_pts,
                                          base_valid).to(torch.uint8)
            coarse = correlate_scan(
                grid, p, grid_center, center, pts, bvalid, self.coarse_x,
                self.coarse_y, n_ang, angle_offset, p.angle_res,
                do_penalize=do_penalize)
            cov = positional_covariance(
                p, coarse.best_pose, coarse.best_response, center,
                self.coarse_x, self.coarse_y, p.angle_res,
                coarse.search_probs)
            pose, response = coarse.best_pose, coarse.best_response
            if do_fine:
                fine = correlate_scan(
                    grid, p, grid_center, pose, pts, bvalid, self.fine_x,
                    self.fine_y, self.n_angles_fine, self.fine_angle_offset,
                    p.fine_angle_offset, do_penalize=True)
                cov = angular_covariance(
                    fine.best_pose, fine.best_response, pose,
                    self.fine_angle_offset, p.fine_angle_offset,
                    fine.angle_responses, cov)
                pose, response = fine.best_pose, fine.best_response
            return MatchResult(pose, torch.clamp(response, max=1.0), cov)

        return f

    @staticmethod
    def _pack(r: MatchResult) -> torch.Tensor:
        """(..., 13): pose | response | covariance, read back in one copy."""
        return torch.cat([r.pose, r.response[..., None],
                          r.covariance.flatten(-2)], -1)

    def _full_packed(self, angle_offset: float, do_penalize: bool,
                     do_fine: bool):
        """One base-point set: base_pts (K, 2) → packed (13,)."""
        f = self._match_fn(angle_offset, do_penalize, do_fine)

        def packed(base_pts, base_valid, pts, bvalid, scan_pose):
            return self._pack(f(base_pts[None], base_valid[None], pts,
                                bvalid, scan_pose))[0]

        return packed

    def _chain_lanes(self, f, poses, pts_l, valid, spts, svalid, spose):
        """World transform + FindValidPoints view filter of C lanes of S
        scans each, then the match: packed (C, 13). The query scan and its
        pose are shared ((N, 2), (N,), (3,)) or a lane's own ((C, N, 2),
        (C, N), (C, 3))."""
        C, S, N = valid.shape
        wp = apply_pose(poses, pts_l)
        keep = find_valid_points(wp, valid, spose[..., None, :2])
        return self._pack(f(wp.reshape(C, S * N, 2), keep.reshape(C, S * N),
                            spts, svalid, spose))

    def _full_chains(self, n_chains: int, n_scans: int, n_beams: int,
                     angle_offset: float, do_penalize: bool, do_fine: bool):
        """The same scan against ``n_chains`` base-scan sets in one pass
        (the near-chain / loop-chain fan-out of AddEdges and TryCloseLoop,
        Mapper.cpp:902-1051). It takes ONE packed float32 buffer (poses |
        base pts | base valid | scan pts | beam valid | pose) and returns
        the (C, 13) result."""
        C, S, N = n_chains, n_scans, n_beams
        f = self._match_fn(angle_offset, do_penalize, do_fine)

        def packed(buf):
            o = 0
            poses = buf[o:o + C * S * 3].view(C, S, 3)
            o += C * S * 3
            bpts = buf[o:o + C * S * N * 2].view(C, S, N, 2)
            o += C * S * N * 2
            bvalid = buf[o:o + C * S * N].view(C, S, N) > 0.5
            o += C * S * N
            spts = buf[o:o + N * 2].view(N, 2)
            o += N * 2
            svalid = buf[o:o + N] > 0.5
            o += N
            return self._chain_lanes(f, poses, bpts, bvalid, spts, svalid,
                                     buf[o:o + 3])

        return packed

    def _full_chains_store(self, n_chains: int, n_scans: int, n_beams: int,
                           cap: tuple, angle_offset: float,
                           do_penalize: bool, do_fine: bool):
        """Index-addressed ``_full_chains``: base-scan points live in the
        device store (cap, N, 2) + (cap, N) and chains arrive as row
        indices, so a call uploads poses and indices, not point data."""
        C, S, N = n_chains, n_scans, n_beams
        f = self._match_fn(angle_offset, do_penalize, do_fine)

        def packed(store_pts, store_valid, buf):
            o = 0
            poses = buf[o:o + C * S * 3].view(C, S, 3)
            o += C * S * 3
            idxf = buf[o:o + C * S].view(C, S)
            o += C * S
            spts = buf[o:o + N * 2].view(N, 2)
            o += N * 2
            svalid = buf[o:o + N] > 0.5
            o += N
            member = idxf >= -0.5  # padded members carry index −1
            idx = torch.clamp(idxf.to(torch.int64), 0, cap[0] - 1)
            bvalid = store_valid[idx] & member[..., None]
            return self._chain_lanes(f, poses, store_pts[idx], bvalid, spts,
                                     svalid, buf[o:o + 3])

        return packed

    def _full_anchor_store(self, n_lanes: int, n_scans: int, cap: tuple,
                           do_penalize: bool, do_fine: bool):
        """Multi-query ``_full_chains_store``: each lane matches its own
        query scan (a store row) at its own search centre against its own
        base-scan set, all C lanes through one grid build and one response
        launch per pass. Built for the offline anchor sweep
        (``models/offline.py``). It takes one packed float32 buffer
        [base_poses (C, S, 3) | base idx (C, S) | query idx (C,) | query
        poses (C, 3)], padded members at index −1, and returns (C, 13)."""
        C, S = n_lanes, n_scans
        f = self._match_fn(self.p.angle_offset, do_penalize, do_fine)

        def packed(store_pts, store_valid, buf):
            o = 0
            poses = buf[o:o + C * S * 3].view(C, S, 3)
            o += C * S * 3
            idxf = buf[o:o + C * S].view(C, S)
            o += C * S
            qif = buf[o:o + C]
            o += C
            qposes = buf[o:o + C * 3].view(C, 3)
            member = idxf >= -0.5  # padded members carry index −1
            idx = torch.clamp(idxf.to(torch.int64), 0, cap[0] - 1)
            qi = torch.clamp(qif.to(torch.int64), 0, cap[0] - 1)
            bvalid = store_valid[idx] & member[..., None]
            return self._chain_lanes(f, poses, store_pts[idx], bvalid,
                                     store_pts[qi], store_valid[qi], qposes)

        return packed

    def match_anchors_store_async(self, store_pts, store_valid, chain_idx,
                                  base_poses, query_idx, query_poses,
                                  do_penalize: bool = True,
                                  do_fine: bool = True) -> torch.Tensor:
        """Queue one C-lane anchor group on the store's device: store_pts
        (cap, N, 2) laser points and store_valid (cap, N), chain_idx (C, S)
        store rows (−1 a padded member), base_poses (C, S, 3), query_idx
        (C,) each lane's query row, query_poses (C, 3) each lane's search
        centre. Returns the (C, 13) result (pose | response | covariance)
        still on the device: callers queue many groups and read them
        once."""
        C, S = (int(d) for d in np.shape(chain_idx))
        cap = (int(store_pts.shape[0]), int(store_pts.shape[1]))
        buf = torch.as_tensor(np.concatenate([
            np.asarray(base_poses, np.float32).ravel(),
            np.asarray(chain_idx, np.float32).ravel(),
            np.asarray(query_idx, np.float32).ravel(),
            np.asarray(query_poses, np.float32).ravel(),
        ])).to(store_pts.device)
        return self._full_anchor_store(C, S, cap, do_penalize, do_fine)(
            store_pts, store_valid, buf)

    def match_chains_store(self, store_pts, store_valid, chain_idx,
                           base_poses, scan_pts_laser, beam_valid, scan_pose,
                           do_penalize: bool = True, do_fine: bool = True,
                           lane_valid: np.ndarray | None = None
                           ) -> MatchResult:
        """match_chains against the device-resident store: the same
        result, only chain indices cross to the device."""
        return self.match_chains_store_async(
            store_pts, store_valid, chain_idx, base_poses, scan_pts_laser,
            beam_valid, scan_pose, do_penalize, do_fine, lane_valid,
        ).resolve()

    def match_chains_store_async(self, store_pts, store_valid, chain_idx,
                                 base_poses, scan_pts_laser, beam_valid,
                                 scan_pose, do_penalize: bool = True,
                                 do_fine: bool = True,
                                 lane_valid: np.ndarray | None = None
                                 ) -> "PendingChainMatch":
        """Queue one chain group's match on the store's device and return
        a handle; ``resolve()`` reads the (C, 13) result back and runs any
        response expansion. Several groups can be queued before the first
        is read."""
        C, S = (int(d) for d in np.shape(chain_idx))
        N = int(np.shape(scan_pts_laser)[-2])
        cap = (int(store_pts.shape[0]), int(store_pts.shape[1]))
        dev = store_pts.device

        def pack(bp, ci):
            return torch.as_tensor(np.concatenate([
                np.asarray(bp, np.float32).ravel(),
                np.asarray(ci, np.float32).ravel(),
                np.asarray(scan_pts_laser, np.float32).ravel(),
                np.asarray(beam_valid, np.float32).ravel(),
                np.asarray(scan_pose, np.float32).ravel(),
            ])).to(dev)

        out_dev = self._full_chains_store(
            C, S, N, cap, self.p.angle_offset, do_penalize, do_fine,
        )(store_pts, store_valid, pack(base_poses, chain_idx))
        return PendingChainMatch(
            self, out_dev, pack, store_pts, store_valid, base_poses,
            chain_idx, S, N, cap, do_penalize, do_fine, lane_valid)

    @staticmethod
    def _pack_chain_buf(base_poses, base_pts_laser, base_valid,
                        scan_pts_laser, beam_valid, scan_pose) -> np.ndarray:
        return np.concatenate([
            np.asarray(base_poses, np.float32).ravel(),
            np.asarray(base_pts_laser, np.float32).ravel(),
            np.asarray(base_valid, np.float32).ravel(),
            np.asarray(scan_pts_laser, np.float32).ravel(),
            np.asarray(beam_valid, np.float32).ravel(),
            np.asarray(scan_pose, np.float32).ravel(),
        ])

    def match(self, base_pts, base_valid, scan_pts_laser, beam_valid,
              scan_pose, do_penalize: bool = True, do_fine: bool = True
              ) -> MatchResult:
        """One base-point set (K, 2) against the scan; host numpy result.
        One device→host read per pass, and up to three more passes of
        response expansion when the response is zero."""
        p = self.p

        def run(ao):
            raw = to_host(self._full_packed(ao, do_penalize, do_fine)(
                base_pts, base_valid, scan_pts_laser, beam_valid, scan_pose))
            return MatchResult(raw[0:3], raw[3], raw[4:13].reshape(3, 3))

        res = run(p.angle_offset)
        if self.use_response_expansion and float(res.response) < KT_TOLERANCE:
            angle_offset = p.angle_offset
            for _ in range(3):  # widen by 20° up to 3 times (:242-272)
                angle_offset += math.radians(20.0)
                res = run(round(angle_offset, 6))
                if float(res.response) >= KT_TOLERANCE:
                    break
        return res

    def match_chains(self, base_poses, base_pts_laser, base_valid,
                     scan_pts_laser, beam_valid, scan_pose,
                     do_penalize: bool = True, do_fine: bool = True,
                     lane_valid: np.ndarray | None = None) -> MatchResult:
        """Match one scan against C base-scan sets (host arrays: poses
        (C, S, 3), laser points (C, S, N, 2), valid (C, S, N)) in one pass
        and one device→host read. lane_valid (C,): padded lanes take no
        response expansion. Returns host arrays with a leading C axis."""
        p = self.p
        C, S, N = (int(d) for d in np.shape(base_valid))

        def run(n, ao, *arrays):
            buf = torch.as_tensor(self._pack_chain_buf(*arrays)).to(
                self.device)
            return to_host(self._full_chains(n, S, N, ao, do_penalize,
                                           do_fine)(buf))

        out = run(C, p.angle_offset, base_poses, base_pts_laser, base_valid,
                  scan_pts_laser, beam_valid, scan_pose)
        poses = out[:, :3].astype(np.float64)
        resps = out[:, 3].copy()
        covs = out[:, 4:].reshape(C, 3, 3).astype(np.float64)
        if self.use_response_expansion:
            lanes = np.ones(C, bool) if lane_valid is None else np.asarray(
                lane_valid, bool)
            for k in np.nonzero(lanes & (resps < KT_TOLERANCE))[0]:
                angle_offset = p.angle_offset
                for _ in range(3):  # rare path: widen per failing lane
                    angle_offset += math.radians(20.0)
                    o1 = run(1, round(angle_offset, 6),
                             base_poses[k:k + 1], base_pts_laser[k:k + 1],
                             base_valid[k:k + 1], scan_pts_laser, beam_valid,
                             scan_pose)[0]
                    if o1[3] >= KT_TOLERANCE:
                        break
                poses[k] = o1[:3]
                resps[k] = o1[3]
                covs[k] = o1[4:].reshape(3, 3)
        return MatchResult(poses, resps, covs)


class PendingChainMatch:
    """A queued chain-group match: its (C, 13) result still on the
    device."""

    def __init__(self, m, out_dev, pack, store_pts, store_valid, base_poses,
                 chain_idx, S, N, cap, do_penalize, do_fine, lane_valid):
        self._m = m
        self._out = out_dev
        self._pack = pack
        self._args = (store_pts, store_valid, base_poses, chain_idx)
        self._shape = (S, N, cap)
        self._opts = (do_penalize, do_fine)
        self._lanes = lane_valid

    def resolve(self) -> MatchResult:
        """Read the result (the group's one device→host copy), then widen
        the still-failing lanes: each widening round queues every failing
        lane before it reads any, so at most 3 more reads in all."""
        m = self._m
        store_pts, store_valid, base_poses, chain_idx = self._args
        S, N, cap = self._shape
        do_penalize, do_fine = self._opts
        out = to_host(self._out)
        C = out.shape[0]
        poses = out[:, :3].astype(np.float64)
        resps = out[:, 3].copy()
        covs = out[:, 4:].reshape(C, 3, 3).astype(np.float64)
        if m.use_response_expansion:
            lanes = (np.ones(C, bool) if self._lanes is None
                     else np.asarray(self._lanes, bool))
            fails = list(np.nonzero(lanes & (resps < KT_TOLERANCE))[0])
            angle_offset = m.p.angle_offset
            for _ in range(3):
                if not fails:
                    break
                angle_offset += math.radians(20.0)
                fn = m._full_chains_store(1, S, N, cap,
                                          round(angle_offset, 6),
                                          do_penalize, do_fine)
                outs = to_host(torch.cat([
                    fn(store_pts, store_valid,
                       self._pack(base_poses[k:k + 1], chain_idx[k:k + 1]))
                    for k in fails]))
                still = []
                for k, o1 in zip(fails, outs):
                    poses[k] = o1[:3]
                    resps[k] = o1[3]
                    covs[k] = o1[4:].reshape(3, 3)
                    if o1[3] < KT_TOLERANCE:
                        still.append(k)
                fails = still
        return MatchResult(poses, resps, covs)
