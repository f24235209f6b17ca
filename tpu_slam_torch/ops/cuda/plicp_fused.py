"""Batched PL-ICP in one CUDA launch — port of
``tpu_slam/ops/pallas/plicp_fused.py::plicp_match_fused``.

The kernel is ``csrc/plicp_fused.cu``, launched on the shape
``plicp_geometry`` chooses; its plain PyTorch version is
``ops/plicp.plicp_match`` with the plain ``nearest_neighbor``. Tensors on
``cuda`` launch the kernel, tensors on ``cpu`` run the plain version
(``_dispatch.route``). The covariance σ²·inv(H + 1e-6·I) is formed here
from the kernel's H, outside the kernel, as in the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.config import PLICPConfig
from tpu_slam_torch.ops.matching import nearest_neighbor
from tpu_slam_torch.ops.plicp import PLICPResult, covariance_from_h, plicp_match

MAX_PASS = 1024  # sources one pass of a block holds (T x S); more: chunks
MAX_TARGETS = 4096  # targets a staged chunk in shared memory; more: chunks
MAX_THREADS = 1024  # threads a block (plicp_fused.cu)
MAX_SOURCES = 8  # sources a thread (plicp_fused.cu's template instances)
# the S = 2 instance's threads a block (plicp_fused.cu: 2 blocks an SM,
# 80 registers a thread)
PAIR_THREADS = 384
# sources a thread once the batch fills the card (at least one pair an
# SM); chip_sweep.py times 1 … 6 at the bench and mission batches
SOURCES_PER_THREAD = 2
NV1, NV2 = 11, 9  # the two GN steps' sums: per-warp partials in shared
TILE = 32  # targets a bounding box (plicp_fused.cu)
BINS = 1024  # the radix select's histogram (plicp_fused.cu)
BARRIERS_PER_ROUND = 5  # the design's, csrc/plicp_fused.cu
# two around each chunk of targets staged after the first, and one before
# the first is staged again for the next round
STAGING_BARRIERS = 3
# device scratch a source where there are chunks: 2 float4 and a pick
RECORD_FLOATS = 9


class PLICPGeometry(NamedTuple):
    threads: int  # T threads a pair (one block)
    sources: int  # S sources a thread: source (c·S + s)·T + t on thread t
    smem: int  # bytes of dynamic shared memory a block
    source_chunks: int  # C passes of T·S sources
    targets: int  # mc targets a staged chunk
    target_chunks: int  # ⌈M / mc⌉ chunks staged in turn
    lists_global: bool  # the gathered errors and the partials in device
    #                     scratch, not shared memory
    scratch: int  # floats of device scratch a pair (0: none)


def max_threads(sources: int) -> int:
    """The most threads a block of the S-sources instance takes: its
    ``__launch_bounds__`` (``PAIR_THREADS`` for S = 2, else 1024 / S) in
    whole warps."""
    cap = PAIR_THREADS if sources == 2 else MAX_THREADS // sources
    return 32 * (cap // 32)


def list_floats(N: int, threads: int, sources: int, chunks: int) -> int:
    """The 2N gathered errors and the two GN steps' partials of every
    group of 32 sources (C·S·T/32 groups)."""
    return 2 * N + chunks * sources * (threads // 32) * (NV1 + NV2)


def smem_bytes(N: int, M: int, threads: int, sources: int, chunks: int = 1,
               lists: bool = True) -> int:
    """The kernel's shared layout: M staged float4 targets and a float4
    box and a flag per tile of ``TILE`` targets, two ``BINS``-bin
    histograms, the lists (``list_floats``) unless they are in device
    scratch, two quantile slots and two counters."""
    tiles = -(-M // TILE)
    own = list_floats(N, threads, sources, chunks) if lists else 0
    return 16 * (M + tiles) + 4 * (2 * BINS + tiles + own + 4)


def shape_at(N: int, M: int, threads: int, sources: int) -> PLICPGeometry:
    """The kernel's whole shape at T threads × S sources a pass: the
    chunks of sources and of targets, whether the lists fit shared
    memory beside ``MAX_TARGETS`` staged targets, and the scratch (the
    records of every source where either takes chunks, the lists where
    they do not fit)."""
    chunks = -(-N // (threads * sources))
    mc = min(M, MAX_TARGETS)
    smem = smem_bytes(N, mc, threads, sources, chunks)
    lists_global = smem > _build.SMEM_PER_BLOCK
    if lists_global:
        smem = smem_bytes(N, mc, threads, sources, chunks, lists=False)
    scratch = 0
    if chunks > 1 or mc < M or lists_global:
        scratch = RECORD_FLOATS * N
        if lists_global:
            scratch += list_floats(N, threads, sources, chunks)
        scratch = 4 * -(-scratch // 4)  # float4 records
    return PLICPGeometry(threads, sources, smem, chunks, mc, -(-M // mc),
                         lists_global, scratch)


@functools.lru_cache(maxsize=256)
def plicp_geometry(B: int, N: int, M: int, sms: int) -> PLICPGeometry:
    """The kernel's shape for B pairs of N sources and M targets on a card
    of ``sms`` SMs: ``SOURCES_PER_THREAD`` sources a thread once there is
    a pair for every SM, one a thread below that (each pair then has an
    SM to itself, and more warps shorten its rounds); more sources a
    thread where the block would exceed its instance's thread cap. A
    pass holds at most ``MAX_PASS`` sources; more take chunks."""
    spt = SOURCES_PER_THREAD if B >= sms else 1
    n = min(N, MAX_PASS)
    while True:
        threads = 32 * -(-n // (32 * spt))
        sources = -(-n // threads)
        if threads <= max_threads(sources):
            return shape_at(N, M, threads, sources)
        spt += 1


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape or t.device != device:
        raise ValueError(
            f"{name}: expected {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_plicp(src_pts, src_valid, tgt_pts, tgt_valid, cfg: PLICPConfig,
                 init_pose):
    """The kernel's one launch on CUDA tensors: (pose (B, 3), stats (B, 4)
    = error, inliers, converged, 0; H (B, 9) of the last round's second
    step, with the ridge)."""
    if not cfg.use_point_to_line_distance:
        raise ValueError("the PL-ICP kernel implements the point-to-line form")
    B, N, _ = src_pts.shape
    M = tgt_pts.shape[1]
    dev = src_pts.device
    _check("src_pts", src_pts, torch.float32, (B, N, 2), dev)
    _check("src_valid", src_valid, torch.bool, (B, N), dev)
    _check("tgt_pts", tgt_pts, torch.float32, (B, M, 2), dev)
    _check("tgt_valid", tgt_valid, torch.bool, (B, M), dev)
    _check("init_pose", init_pose, torch.float32, (B, 3), dev)
    if not (N > 0 and M > 0):
        raise ValueError(f"beam counts N={N}, M={M} outside the kernel's range")
    if dev.type != "cuda":
        raise ValueError(f"the PL-ICP kernel takes CUDA tensors, not {dev}")
    pose = torch.empty((B, 3), dtype=torch.float32, device=dev)
    stats = torch.empty((B, 4), dtype=torch.float32, device=dev)
    H = torch.empty((B, 9), dtype=torch.float32, device=dev)
    if B > 0:
        geo = plicp_geometry(B, N, M, _dispatch.sm_count(dev))
        scratch = (torch.empty(B * geo.scratch, dtype=torch.float32,
                               device=dev) if geo.scratch else None)
        _build.launch(
            "plicp_fused",
            src_pts.data_ptr(), src_valid.data_ptr(), tgt_pts.data_ptr(),
            tgt_valid.data_ptr(), init_pose.data_ptr(), pose.data_ptr(),
            stats.data_ptr(), H.data_ptr(), B, N, M, cfg.max_iterations,
            cfg.max_correspondence_dist**2, cfg.epsilon_xy, cfg.epsilon_theta,
            cfg.outliers_maxPerc, cfg.outliers_adaptive_order,
            cfg.outliers_adaptive_mult, geo.threads, geo.sources, geo.smem,
            geo.targets, int(geo.lists_global),
            scratch.data_ptr() if scratch is not None else None,
            geo.scratch, torch.cuda.current_stream(dev).cuda_stream,
        )
        _dispatch.count_launch("plicp_fused")
    return pose, stats, H


def plicp_match_fused(
    src_pts: torch.Tensor,  # (B, N, 2) float32
    src_valid: torch.Tensor,  # (B, N) bool
    tgt_pts: torch.Tensor,  # (B, M, 2) float32
    tgt_valid: torch.Tensor,  # (B, M) bool
    cfg: PLICPConfig,
    init_pose: torch.Tensor | None = None,  # (B, 3) float32
) -> PLICPResult:
    """Batched point-to-line PL-ICP with per-pair convergence; the same
    PLICPResult fields as ``ops/plicp.plicp_match``."""
    if _dispatch.route(src_pts) == "cpu":
        return plicp_match(src_pts, src_valid, tgt_pts, tgt_valid, cfg,
                           init_pose=init_pose, nn=nearest_neighbor)
    B = src_pts.shape[0]
    if init_pose is None:
        init_pose = torch.zeros((B, 3), dtype=torch.float32,
                                device=src_pts.device)
    pose, stats, H = launch_plicp(src_pts, src_valid, tgt_pts, tgt_valid,
                                  cfg, init_pose)
    return PLICPResult(
        pose=pose,
        error=stats[:, 0],
        num_inliers=stats[:, 1].to(torch.int32),
        covariance=covariance_from_h(H.view(B, 3, 3), cfg),
        converged=stats[:, 2] > 0.5,
    )
