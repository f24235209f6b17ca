"""The offline driver's loop-candidate sweep: the pose-proximity pairs, the
nearest pair of each index cell and the greedy non-maximum suppression in
one pass on the card (``csrc/loop_sweep.cu``), or in its plain PyTorch
version ``loop_sweep_plain`` on the CPU (``_dispatch.route``).

The semantics are those of the reference's host sweep
(``tpu_slam/models/offline.py::_loop_candidates``):

1. the pairs (i, j) with ``j - i >= min_gap`` and d2 <= r2, r2 the float32
   square of the float32 radius;
2. of each (g × g) index cell, g = max(``nms_gap``, 1), only the nearest
   pair; if that pair is in ``tried`` the cell yields nothing;
3. the survivors walked in ascending order, each kept unless a pair kept
   before it lies within ``nms_gap`` of it in both indices;
4. at most max(``max_candidates``, 1) pairs kept.

The order is the key (d2, i, j), which is total: it is the reference's
order with its ties settled as a stable sort settles them (the reference's
``argsort`` is not stable). d2 is the reference's float32 expansion as a
float32 matrix product with fused multiply-adds evaluates it:

    d2 = (n2_i + n2_j) - 2 · fma(y_i, y_j, x_i · x_j),  n2 = x · x + y · y,

each other operation rounded on its own. A suppressing pair lies in one of
the 3 × 3 cells around a survivor's cell (g ≥ ``nms_gap`` wherever the
gap suppresses anything), so the walk looks only there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch import _build, _dispatch

MAX_SCANS = 65535  # the kernel's pair index i·T + j is 32 bits
MAX_CELLS = 2 ** 29  # index cells: its sort's int sizes stay below 2^31
ROWS_ELEMS = 1 << 20  # pairs a block of rows of the plain version


def radius2(radius: float) -> float:
    """The float32 square of the float32 radius, as the reference forms
    it."""
    return float(np.float32(radius) ** 2)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fma(a, b, c) of float32 tensors, rounded once to float32: a · b is
    exact in float64; the float64 sum is rounded to odd (the two-sum's
    error sets the last bit), which the float32 rounding then turns into
    the correctly rounded result."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    bits = s.view(torch.int64)
    step = torch.where((err > 0) == (s > 0), 1, -1)
    fix = (err != 0) & ((bits & 1) == 0)
    return torch.where(fix, bits + step, bits).view(torch.float64).float()


def _pairs(xy: torch.Tensor, r2: float, min_gap: int):
    """(i, j, d2) of the in-radius pairs with ``j - i >= min_gap``, in
    (i, j) order. A block of rows at a time keeps the pairs near enough by
    their float32 differences, and the expansion is worked out for those
    alone. The expansion lies within ~6 · 2^-24 · (n2_i + n2_j) of the
    true distance; the slack, 2^-19 · (r2 + n2_i + n2_j), is five times
    that, so no pair that the expansion puts in the radius is dropped."""
    T = xy.shape[0]
    x, y = xy[:, 0], xy[:, 1]
    n2 = x * x + y * y
    slack = 2.0 ** -19
    rows = max(1, ROWS_ELEMS // max(T, 1))
    ii, jj = [], []
    for r0 in range(0, T, rows):
        r1 = min(r0 + rows, T)
        c0 = min(max(0, r0 + min_gap), T)
        xi, yi = x[r0:r1, None], y[r0:r1, None]
        near = ((xi - x[c0:]) ** 2 + (yi - y[c0:]) ** 2
                <= r2 * (1 + slack) + slack * (n2[r0:r1, None] + n2[c0:]))
        near &= (torch.arange(c0, T, device=xy.device)
                 - torch.arange(r0, r1, device=xy.device)[:, None]
                 >= min_gap)
        bi, bj = torch.nonzero(near, as_tuple=True)
        ii.append(bi + r0)
        jj.append(bj + c0)
    i, j = torch.cat(ii), torch.cat(jj)
    d2 = (n2[i] + n2[j]) - _fma(y[i], y[j], x[i] * x[j]) * 2
    keep = d2 <= r2
    return i[keep], j[keep], d2[keep]


def loop_sweep_plain(poses: torch.Tensor, radius: float, min_gap: int,
                     nms_gap: int, max_candidates: int, tried: set
                     ) -> tuple[list[tuple[int, int]], int]:
    """The sweep in plain PyTorch, on the host or on ``poses``' device:
    (the kept pairs in order, the live cells: the cells that hold an
    in-radius pair)."""
    T = poses.shape[0]
    if T == 0:
        return [], 0
    g = max(nms_gap, 1)
    xy = poses[:, :2].to(torch.float32)
    ii, jj, dd = _pairs(xy, radius2(radius), min_gap)
    # the (d2, i, j) order: a stable sort of pairs listed in (i, j) order
    by_key = torch.sort(dd, stable=True).indices
    nc = -(-T // g)
    cell = ((ii // g) * nc + jj // g)[by_key]
    by_cell = torch.sort(cell, stable=True).indices
    cs = cell[by_cell]
    first = torch.ones_like(cs, dtype=torch.bool)
    first[1:] = cs[1:] != cs[:-1]
    winners = by_key[torch.sort(by_cell[first]).values]
    cap = max(max_candidates, 1)
    kept: dict[tuple[int, int], tuple[int, int]] = {}
    picked: list[tuple[int, int]] = []
    for i, j in zip(ii[winners].tolist(), jj[winners].tolist()):
        if len(picked) >= cap:
            break
        if (i, j) in tried:
            continue
        ci, cj = i // g, j // g
        near = (kept.get((ci + di, cj + dj))
                for di in (-1, 0, 1) for dj in (-1, 0, 1))
        if any(q is not None and abs(i - q[0]) < nms_gap
               and abs(j - q[1]) < nms_gap for q in near):
            continue
        kept[ci, cj] = (i, j)
        picked.append((i, j))
    return picked, len(winners)


def loop_sweep_cuda(poses: torch.Tensor, radius: float, min_gap: int,
                    nms_gap: int, max_candidates: int, tried: set
                    ) -> tuple[list[tuple[int, int]], int]:
    """The sweep in two launches on ``poses``' card, ending in one read of
    the kept pairs and the live-cell count."""
    dev = poses.device
    if poses.dim() != 2 or poses.shape[1] < 2:
        raise ValueError(
            f"poses: expected (T, >= 2), got {tuple(poses.shape)}")
    T = poses.shape[0]
    if T > MAX_SCANS:
        raise ValueError(f"T={T} scans: the loop sweep kernel takes at most "
                         f"{MAX_SCANS}")
    if T == 0:
        return [], 0
    if poses.dtype != torch.float32:
        poses = poses.float()
    if poses.stride(1) != 1:
        poses = poses.contiguous()
    g = min(max(nms_gap, 1), T)
    nc = -(-T // g)
    cells = nc * nc
    if cells > MAX_CELLS:
        raise ValueError(f"{cells} index cells (T={T}, gap {nms_gap}): the "
                         f"loop sweep kernel takes at most {MAX_CELLS}")
    cap = min(max(max_candidates, 1), cells)
    pairs = [p for p in tried if 0 <= p[0] < T and 0 <= p[1] < T]
    tr = (torch.as_tensor(np.asarray(pairs, np.int32), device=dev)
          if pairs else None)
    # each cell's key, then the live keys padded to a power of two: the
    # sort runs there where they outgrow shared memory
    work = torch.empty(cells + (1 << (cells - 1).bit_length()),
                       dtype=torch.int64, device=dev)
    out = torch.empty(2 + 2 * cap, dtype=torch.int32, device=dev)
    _build.launch(
        "loop_sweep", poses.data_ptr(), poses.stride(0), T,
        None if tr is None else tr.data_ptr(), len(pairs), work.data_ptr(),
        work[cells:].data_ptr(), out.data_ptr(), g,
        min(max(nms_gap, 0), T + 1), min(max(min_gap, -T), T + 1),
        radius2(radius), cap, torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("loop_sweep")
    o = out.cpu().tolist()
    n = o[0]
    return list(zip(o[2:2 + 2 * n:2], o[3:3 + 2 * n:2])), o[1]


def loop_sweep(poses: torch.Tensor, radius: float, min_gap: int,
               nms_gap: int, max_candidates: int, tried: set
               ) -> tuple[list[tuple[int, int]], int]:
    """The loop candidates of ``poses`` ((T, >= 2), x and y first) and the
    live cells: the kernel for a tensor on ``cuda``, the plain version
    for one on ``cpu``."""
    fn = (loop_sweep_cuda if _dispatch.route(poses) == "cuda"
          else loop_sweep_plain)
    return fn(poses, radius, min_gap, nms_gap, max_candidates, tried)
