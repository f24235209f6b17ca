"""The correlative response numerators in one CUDA launch — port of
``tpu_slam/ops/pallas/correlative_response.py::responses_sliced_pallas``.

The kernel is ``csrc/correlative_response.cu``; its plain PyTorch version
is ``ops/correlative.sum_windows``. Grids on ``cuda`` launch the kernel,
grids on ``cpu`` run the plain version (``_dispatch.route``). Both take
the window starts that ``ops/correlative.window_starts`` computes once.
"""

from __future__ import annotations

import dataclasses

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.ops import correlative
from tpu_slam_torch.ops.cuda.plicp_fused import _check

# csrc/correlative_response.cu
STAGE = 512  # valid beams staged a round, summed in 16-bit halves
MIN_THREADS, MAX_THREADS = 64, 1024
CLASSES = 8  # the row path: a window's start in its first 8-byte chunk
BYTES = (2,)  # the byte path's candidates a thread
# the wrapper's choice (chip_sweep.py correlative)
ROW_WARPS = 8  # a block of the row path
BYTE_WARPS = 4  # a block of the byte path
BLOCKS_PER_SM = 2  # the byte path's blocks of BYTE_WARPS an SM, at least
SLICE_BEAMS = 4  # fewest beams a slice of the byte path sums


@dataclasses.dataclass(frozen=True)
class ResponseGeometry:
    """A launch of the response kernel. R = 0: the row path (a thread an
    aligned 8-byte chunk of a lattice row's window, ``strips`` = whole
    rows of chunks a block, one slice); R = 2: the byte path (R
    candidates a thread, ``strips`` strips of R candidates a block's
    tile, ``slices`` beam slices, strips × slices ≤ threads)."""
    R: int
    threads: int
    strips: int
    slices: int

    @property
    def path(self) -> str:
        return "bytes" if self.R else "rows"

    def strips_row(self, nx: int, stride: int) -> int:
        if self.R:
            return -(-nx // self.R)
        return (7 + (nx - 1) * stride) // 8 + 1

    def blocks(self, C: int, A: int, nx: int, ny: int, stride: int) -> int:
        return C * A * -(-ny * self.strips_row(nx, stride) // self.strips)

    def smem(self, stride: int) -> int:
        """Bytes of shared memory a block takes (csrc's launch): the
        staged origins, then the row path's class sums or the byte path's
        slice partials."""
        if not self.R:
            return 4 * (STAGE + self.threads * CLASSES * (8 // stride))
        parts = self.slices * ((self.strips * self.R) | 1)
        return 4 * (STAGE + (parts if self.slices > 1 else 0))


def shape_at(C: int, A: int, W: int, nx: int, ny: int, stride: int, N: int,
             sms: int, R: int, warps: int) -> ResponseGeometry:
    """The launch at R candidates a thread (0: the row path) and ``warps``
    a block, for grids W bytes wide. The row path (strides 1 and 2, rows
    of the grid a multiple of 8 bytes apart at the stride, so that a
    window's class is the same in every row) takes as many whole rows as
    the block holds. The byte path splits a block's beams into as many
    slices (of at least SLICE_BEAMS beams) as give the pass
    BLOCKS_PER_SM × ``sms`` blocks' threads, and cuts the lattice into
    tiles of the strips the rest of the threads hold. Raises where the
    kernel has no such launch."""
    threads = 32 * warps
    if not MIN_THREADS <= threads <= MAX_THREADS:
        raise ValueError(f"{warps} warps: outside the kernel's block sizes")
    if R == 0:
        geo = ResponseGeometry(0, threads, 0, 1)
        per_row = geo.strips_row(nx, stride)
        if stride not in (1, 2) or stride * W % 8 or per_row > threads:
            raise ValueError(f"no row-path launch at stride {stride}, rows "
                             f"of {W} bytes, {per_row} chunks a row, "
                             f"{threads} threads")
        geo = ResponseGeometry(0, threads, threads // per_row * per_row, 1)
        if geo.smem(stride) > _build.SMEM_PER_BLOCK:
            raise ValueError(f"{warps} warps: the row path's class sums "
                             "exceed a block's shared memory")
        return geo
    if R not in BYTES:
        raise ValueError(f"no kernel instance for R={R}")
    strips = ny * -(-nx // R)
    most = -(-N // SLICE_BEAMS)
    slices = BLOCKS_PER_SM * sms * threads // (C * A * strips)
    slices = max(1, min(threads, most, slices))
    tile = max(1, min(strips, threads // slices))
    return ResponseGeometry(R, threads, tile, min(threads // tile, most))


def response_geometry(C: int, A: int, W: int, nx: int, ny: int,
                      stride: int, N: int, sms: int) -> ResponseGeometry:
    """The wrapper's launch: the row path (ROW_WARPS warps) where it runs,
    the rows span 32 bytes or more and their chunks fill the card twice
    over; else the byte path at 2 candidates a thread, BYTE_WARPS warps."""
    if stride in (1, 2) and stride * W % 8 == 0 and nx * stride >= 32:
        per_row = (7 + (nx - 1) * stride) // 8 + 1
        if C * A * ny * per_row >= 2 * sms * 32 * ROW_WARPS:
            return shape_at(C, A, W, nx, ny, stride, N, sms, 0, ROW_WARPS)
    return shape_at(C, A, W, nx, ny, stride, N, sms, 2, BYTE_WARPS)


def responses_sliced(grid, ys, xs, beam_valid, n_x: int, n_y: int,
                     stride: int) -> torch.Tensor:
    """(C, A, nY·nX) int32: for every lane, angle and candidate (y, x),
    the sum over valid beams of grid[c, ys + y·stride, xs + x·stride].
    grid (C, H, W) uint8 (values 0..100), ys/xs (C, A, N) int32 window
    starts, beam_valid (C, N) bool: a lane's own flags, or one scan's
    shared by the lanes as ``flags.expand(C, N)`` (lane stride 0)."""
    if _dispatch.route(grid) == "cpu":
        return correlative.sum_windows(grid, ys, xs, beam_valid, n_x, n_y,
                                       stride)
    dev = grid.device
    if grid.dim() != 3 or ys.dim() != 3:
        raise ValueError("expected grid (C, H, W) and starts (C, A, N)")
    C, H, W = grid.shape
    A, N = ys.shape[1:]
    if N < 1 or (n_x - 1) * stride + 1 > W or (n_y - 1) * stride + 1 > H:
        raise ValueError(f"a {n_y} x {n_x} lattice at stride {stride} does "
                         f"not fit a {H} x {W} grid, or no beam")
    _check("grid", grid, torch.uint8, (C, H, W), dev)
    _check("ys", ys, torch.int32, (C, A, N), dev)
    _check("xs", xs, torch.int32, (C, A, N), dev)
    if (beam_valid.dtype != torch.bool or beam_valid.shape != (C, N)
            or beam_valid.device != dev or beam_valid.stride(1) != 1):
        raise ValueError(
            f"beam_valid: expected bool ({C}, {N}) on {dev}, each lane's "
            f"beams contiguous, got {beam_valid.dtype} "
            f"{tuple(beam_valid.shape)} strides {beam_valid.stride()} on "
            f"{beam_valid.device}")
    geo = response_geometry(C, A, W, n_x, n_y, stride, N,
                            _dispatch.sm_count(dev))
    out = torch.empty((C, A, n_y * n_x), dtype=torch.int32, device=dev)
    _build.launch(
        "correlative_response", grid.data_ptr(), ys.data_ptr(),
        xs.data_ptr(), beam_valid.data_ptr(), out.data_ptr(), C, H, W, A, N,
        n_x, n_y, stride, beam_valid.stride(0), geo.R, geo.threads,
        geo.strips, geo.slices, torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("correlative_response")
    return out
