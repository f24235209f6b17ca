"""The correlative response numerators in one CUDA launch — port of
``tpu_slam/ops/pallas/correlative_response.py::responses_sliced_pallas``.

The kernel is ``csrc/correlative_response.cu``; its plain PyTorch version
is ``ops/correlative.sum_windows``. Grids on ``cuda`` launch the kernel,
grids on ``cpu`` run the plain version (``_dispatch.route``). Both take
the window starts that ``ops/correlative.window_starts`` computes once.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.ops import correlative
from tpu_slam_torch.ops.cuda.plicp_fused import _check

MAX_CHUNK = 1024  # csrc/correlative_response.cu
BEAMS_MIN = 32  # fewest beams a block sums when the beams are split


def beam_chunk(C: int, A: int, n_cand: int, N: int, sms: int) -> int:
    """Beams per thread block: all of them when the lanes, angles and
    candidate tiles already give a card of ``sms`` SMs ~4 blocks per SM,
    else split so they do (at least BEAMS_MIN beams per block)."""
    tiles = -(-n_cand // 256)
    split = -(-4 * sms // (C * A * tiles))
    split = max(1, min(split, -(-N // BEAMS_MIN)))
    split = max(split, -(-N // MAX_CHUNK))
    return -(-N // split)


def responses_sliced(grid, ys, xs, beam_valid, n_x: int, n_y: int,
                     stride: int) -> torch.Tensor:
    """(C, A, nY·nX) int32: for every lane, angle and candidate (y, x),
    the sum over valid beams of grid[c, ys + y·stride, xs + x·stride].
    grid (C, H, W) uint8 (values 0..100), ys/xs (C, A, N) int32 window
    starts, beam_valid (N,) bool."""
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
    _check("beam_valid", beam_valid, torch.bool, (N,), dev)
    out = torch.zeros((C, A, n_y * n_x), dtype=torch.int32, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _build.launch(
        "correlative_response", grid.data_ptr(), ys.data_ptr(),
        xs.data_ptr(), beam_valid.data_ptr(), out.data_ptr(), C, H, W, A, N,
        n_x, n_y, stride, beam_chunk(C, A, n_x * n_y, N, sms),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("correlative_response")
    return out
