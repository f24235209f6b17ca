"""Batched exhaustive nearest neighbour in one CUDA launch — port of
``tpu_slam/ops/pallas/nn.py::nearest_neighbor_pallas``.

The kernel is ``csrc/nn.cu``, launched on the shape ``nn_geometry``
chooses; its plain PyTorch version is ``ops/matching.nearest_neighbor_direct``,
which it equals bit for bit in both outputs. Tensors on ``cuda`` launch the
kernel, tensors on ``cpu`` run the plain version (``_dispatch.route``).
Callers reach it through ``ops/matching.nearest_neighbor_auto``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.ops.cuda.plicp_fused import _check
from tpu_slam_torch.ops.matching import nearest_neighbor_direct

MAX_TARGETS = 4096  # targets a staged chunk in shared memory: 16 B each
# the grid's y extent, a hardware bound: tiles of one pair's sources. At
# one lane a source (G = 1 once N ≥ 67,584 on 132 SMs) N = 16,776,961
# first reaches it
MAX_TILES = 65535
MAX_THREADS = 256  # threads a block (nn.cu)
MAX_LANES = 32  # lanes that share a source: one warp (nn.cu)
# the card counts as full at this many lanes an SM; chip_sweep.py times
# every G at the odometry's and the batches' shapes
LANES_PER_SM = 512


class NNGeometry(NamedTuple):
    lanes: int  # G: lanes that share a source, each a strided share of M
    threads: int  # threads a block
    tiles: int  # blocks a pair (the grid is (B, tiles)), each of
    #             threads / G sources
    smem: int  # bytes of shared memory a block: the staged targets
    targets: int  # targets a staged chunk: all M up to MAX_TARGETS
    chunks: int  # ⌈M / targets⌉ chunks staged in turn


@functools.lru_cache(maxsize=256)
def nn_geometry(B: int, N: int, M: int, sms: int) -> NNGeometry:
    """The kernel's shape for B pairs of N sources and M targets on a card
    of ``sms`` SMs: while B·N·G lanes do not fill the card
    (``LANES_PER_SM`` a SM), G doubles, up to a warp."""
    fill = sms * LANES_PER_SM
    lanes = 1
    while lanes < MAX_LANES and B * N * lanes < fill:
        lanes *= 2
    return tile_sources(N, M, lanes)


def tile_sources(N: int, M: int, lanes: int) -> NNGeometry:
    """The kernel's shape at ``lanes`` a source: a pair's N sources cut
    into even tiles of whole warps, at most ``MAX_THREADS`` a block; the
    M targets staged ``MAX_TARGETS`` at a time."""
    slots = N * lanes  # threads a pair needs
    tiles = -(-slots // MAX_THREADS)
    threads = 32 * -(-slots // (32 * tiles))
    mc = min(M, MAX_TARGETS)
    return NNGeometry(lanes, threads, tiles, 16 * mc, mc, -(-M // mc))


def nearest_neighbor_cuda(
    src: torch.Tensor,  # (B, N, 2) float32
    tgt: torch.Tensor,  # (B, M, 2) float32
    tgt_valid: torch.Tensor,  # (B, M) bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """For each source point the index (int64) and squared distance of the
    nearest valid target of its pair: (idx (B, N), d2 (B, N)); invalid
    targets count at +1e12, ties go to the first index, and a source with
    a NaN distance to any target of its pair gets (M, NaN), as the
    reference kernel gives."""
    if _dispatch.route(src) == "cpu":
        return nearest_neighbor_direct(src, tgt, tgt_valid)
    B, N, _ = src.shape
    M = tgt.shape[1]
    dev = src.device
    _check("src", src, torch.float32, (B, N, 2), dev)
    _check("tgt", tgt, torch.float32, (B, M, 2), dev)
    _check("tgt_valid", tgt_valid, torch.bool, (B, M), dev)
    if not (M > 0 and N > 0):
        raise ValueError(f"N={N}, M={M} outside the NN kernel's range")
    idx = torch.empty((B, N), dtype=torch.int64, device=dev)
    d2 = torch.empty((B, N), dtype=torch.float32, device=dev)
    if B > 0:
        geo = nn_geometry(B, N, M, _dispatch.sm_count(dev))
        if geo.tiles > MAX_TILES:
            raise ValueError(f"N={N} outside the NN kernel's range")
        _build.launch(
            "nn", src.data_ptr(), tgt.data_ptr(), tgt_valid.data_ptr(),
            idx.data_ptr(), d2.data_ptr(), B, N, M, geo.lanes, geo.threads,
            geo.tiles, geo.smem, geo.targets,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _dispatch.count_launch("nn")
    return idx, d2
