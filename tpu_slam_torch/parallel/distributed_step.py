"""Batched PL-ICP matcher factories — port of the single-device factories of
``tpu_slam/parallel/distributed_step.py``.

Every factory returns a plain callable over tensors. The match runs the
PL-ICP kernel (point-to-line) or the NN kernel in each round of
``plicp_match`` (point-to-point) when the tensors are on ``cuda``, and
the plain versions on ``cpu`` (``_match_fn``). The mesh (sharded) forms
are not ported.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.matching import nearest_neighbor_auto
from tpu_slam_torch.ops.plicp import PLICPResult, plicp_match

_MESH_MSG = ("the sharded matcher is not ported yet "
             "(ROADMAP queue 1, item 11: multi-device layer)")


def _match_fn(cfg: SLAMConfig):
    """The batched PL-ICP callable (sp, sv, tp, tv, guesses) → PLICPResult.
    The point-to-line form goes through the PL-ICP kernel's wrapper. The
    point-to-point form runs ``plicp_match``, as the reference does on its
    TPU (``tpu_slam/parallel/distributed_step.py:304-305``): each round
    takes its correspondences from ``nearest_neighbor_auto``, which
    launches the NN kernel on ``cuda``."""
    if cfg.plicp.use_point_to_line_distance:
        return lambda sp, sv, tp, tv, g: plicp_match_fused(
            sp, sv, tp, tv, cfg.plicp, init_pose=g)
    return lambda sp, sv, tp, tv, g: plicp_match(
        sp, sv, tp, tv, cfg.plicp, init_pose=g, nn=nearest_neighbor_auto)


def _pack_result(r: PLICPResult) -> torch.Tensor:
    """(B, 14) float32: [pose(3), error(1), num_inliers(1), cov.flat(9)]."""
    B = r.pose.shape[0]
    return torch.cat(
        [
            r.pose.to(torch.float32),
            r.error.reshape(B, 1).to(torch.float32),
            r.num_inliers.reshape(B, 1).to(torch.float32),
            r.covariance.reshape(B, 9).to(torch.float32),
        ],
        dim=-1,
    )


def _gather_scan(store: torch.Tensor, idx: torch.Tensor,
                 dirs: torch.Tensor) -> torch.Tensor:
    """Scan rows of the store at idx; a (U, N) ranges store expands to
    (B, N, 2) points with the (N, 2) beam-direction table, a (U, N, 2)
    points store passes through."""
    g = store[idx]
    if g.dim() == 2:
        return (g[..., None] * dirs[None, :, :]).contiguous()
    return g


def _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses):
    return base(
        _gather_scan(store, src_idx, dirs), store_valid[src_idx],
        _gather_scan(store, tgt_idx, dirs), store_valid[tgt_idx],
        guesses,
    )


def make_batched_matcher(cfg: SLAMConfig, mesh=None):
    """Batched PL-ICP matcher over (B, N, 2) pair batches."""
    if mesh is not None:
        raise NotImplementedError(_MESH_MSG)
    return _match_fn(cfg)


def make_packed_indexed_matcher(cfg: SLAMConfig, mesh=None):
    """Matcher over a scan store by row index; returns ONE (B, 14) float32
    tensor ``[pose(3), error(1), num_inliers(1), covariance.flat(9)]``."""
    if mesh is not None:
        raise NotImplementedError(_MESH_MSG)
    base = _match_fn(cfg)

    def f(store, store_valid, dirs, src_idx, tgt_idx, guesses):
        return _pack_result(
            _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses)
        )

    return f


def make_chain_matcher(cfg: SLAMConfig):
    """Packed chain match plus pose integration in one call.

    Returns (2B+1, 14): rows [:B] are the packed per-pair results, rows
    [B:] the integrated trajectory compose_chain(pose0, rels) zero-padded
    to 14 columns. Padded pairs only affect trajectory rows past the real
    scan count, which the caller slices off."""
    return _chain_matcher(_match_fn(cfg))


def _chain_matcher(base):
    """``make_chain_matcher`` over the batched match callable ``base``."""

    def f(store, store_valid, dirs, src_idx, tgt_idx, guesses, pose0):
        r = _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses)
        poses = geo.compose_chain(pose0, r.pose.to(torch.float32))
        return torch.cat(
            [_pack_result(r), torch.nn.functional.pad(poses, (0, 11))], dim=0
        )

    return f


def make_loop_selector(cfg: SLAMConfig, n_seeds: int):
    """Multi-start loop match plus per-candidate best-seed selection:
    returns (C, 16) rows ``[pose(3), error(1), num_inliers(1),
    cov.flat(9), frac(1), accept(1)]`` for the winning seed of each of C
    candidates.

    The C·S pairs must come as C contiguous blocks of S pairs that share
    one source scan (checked). A seed is eligible when its inlier fraction
    clears ``gates[0]`` and its result stays inside the seeded basin
    (``gates[1]`` m, ``gates[2]`` rad); the best eligible seed must also
    clear the error gate ``gates[3]``. The gates are evaluated in float32,
    like the reference's device path."""
    return _loop_selector(_match_fn(cfg), n_seeds)


def _loop_selector(base, S: int):
    """``make_loop_selector`` over the batched match callable ``base``."""

    def f(store, store_valid, dirs, src_idx, tgt_idx, guesses, rel_pred,
          gates):
        C = rel_pred.shape[0]
        src_cs = src_idx.reshape(C, S)
        if not torch.equal(src_cs, src_cs[:, :1].expand(C, S)):
            raise ValueError(
                "loop selector: pairs must come as C blocks of S seeds "
                "sharing one source scan"
            )
        r = _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses)
        packed = _pack_result(r).reshape(C, S, 14)
        # valid beams of each candidate's source scan
        nv = torch.sum(store_valid[src_cs[:, 0]], dim=-1).to(torch.float32)
        frac = packed[:, :, 4] / torch.clamp(nv[:, None], min=1.0)
        dev = packed[:, :, :3] - rel_pred[:, None, :]
        dev_th = torch.atan2(torch.sin(dev[:, :, 2]), torch.cos(dev[:, :, 2]))
        in_basin = (
            (torch.hypot(dev[:, :, 0], dev[:, :, 1]) <= gates[1])
            & (torch.abs(dev_th) <= gates[2])
        )
        ok = (frac >= gates[0]) & in_basin
        err = torch.where(ok, packed[:, :, 3],
                          torch.full_like(packed[:, :, 3], float("inf")))
        best = torch.argmin(err, dim=1)
        rows = torch.arange(C, device=best.device)
        best_err = err[rows, best]
        accept = torch.isfinite(best_err) & (best_err <= gates[3])
        return torch.cat(
            [
                packed[rows, best],
                frac[rows, best][:, None],
                accept[:, None].to(torch.float32),
            ],
            dim=-1,
        )

    return f
