"""Batched exhaustive nearest neighbour in one CUDA launch — port of
``tpu_slam/ops/pallas/nn.py::nearest_neighbor_pallas``.

The kernel is ``csrc/nn.cu``; its plain PyTorch version is
``ops/matching.nearest_neighbor_direct``, which it equals bit for bit in
both outputs. Tensors on ``cuda`` launch the kernel, tensors on ``cpu`` run
the plain version (``_dispatch.route``). Callers reach it through
``ops/matching.nearest_neighbor_auto``.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.ops.cuda.plicp_fused import _check
from tpu_slam_torch.ops.matching import nearest_neighbor_direct

MAX_TARGETS = 4096  # targets staged in shared memory: 9 bytes each
MAX_TILES = 65535  # the grid's y extent, 256 sources per tile


def nearest_neighbor_cuda(
    src: torch.Tensor,  # (B, N, 2) float32
    tgt: torch.Tensor,  # (B, M, 2) float32
    tgt_valid: torch.Tensor,  # (B, M) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each source point the index (int64) and squared distance of the
    nearest valid target of its pair: (idx (B, N), d2 (B, N)); invalid
    targets count at +1e12 and ties go to the first index."""
    if _dispatch.route(src) == "cpu":
        return nearest_neighbor_direct(src, tgt, tgt_valid)
    B, N, _ = src.shape
    M = tgt.shape[1]
    dev = src.device
    _check("src", src, torch.float32, (B, N, 2), dev)
    _check("tgt", tgt, torch.float32, (B, M, 2), dev)
    _check("tgt_valid", tgt_valid, torch.bool, (B, M), dev)
    if not (0 < M <= MAX_TARGETS and 0 < N <= 256 * MAX_TILES):
        raise ValueError(f"N={N}, M={M} outside the NN kernel's range")
    idx = torch.empty((B, N), dtype=torch.int64, device=dev)
    d2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B > 0:
        _build.launch(
            "nn", src.data_ptr(), tgt.data_ptr(), tgt_valid.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), B, N, M,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _dispatch.count_launch("nn")
    return idx, d2
