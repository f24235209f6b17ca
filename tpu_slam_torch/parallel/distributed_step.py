"""Batched PL-ICP matcher factories and the distributed SLAM step — port
of ``tpu_slam/parallel/distributed_step.py``.

Every factory returns a plain callable over tensors. The match runs the
PL-ICP kernel (point-to-line) or the NN kernel in each round of
``plicp_match`` (point-to-point) when the tensors are on ``cuda``, and
the plain versions on ``cpu`` (``_match_fn``).

With a mesh (``parallel/mesh.Mesh``) the pair batch is sharded: every
rank passes the same global arguments, matches its block of the pairs
(its own kernel launch on ``cuda``) and gets the whole batch's result,
gathered in one collective. The scan store is replicated. The batch must
tile the mesh; the callers pad it.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import geometry as geo
from tpu_slam_torch.config import SLAMConfig
from tpu_slam_torch.ops.cuda.plicp_fused import plicp_match_fused
from tpu_slam_torch.ops.matching import nearest_neighbor_auto
from tpu_slam_torch.ops.plicp import PLICPResult, plicp_match
from tpu_slam_torch.parallel.mesh import Mesh, all_gather_rows, block
from tpu_slam_torch.solver.distributed import (
    EdgeShard, normal_equations, slot_table,
)
from tpu_slam_torch.solver.lm import dense_solve


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


def _gathered(r: PLICPResult, mesh: Mesh) -> PLICPResult:
    """The whole batch's result from each rank's block, in ONE gather:
    [pose(3), error, num_inliers, cov.flat(9), converged] rows."""
    B = r.pose.shape[0]
    rows = all_gather_rows(torch.cat(
        [_pack_result(r), r.converged.reshape(B, 1).to(torch.float32)],
        dim=-1), mesh)
    n = rows.shape[0]
    return PLICPResult(
        pose=rows[:, 0:3].to(r.pose.dtype),
        error=rows[:, 3].to(r.error.dtype),
        num_inliers=rows[:, 4].to(r.num_inliers.dtype),
        covariance=rows[:, 5:14].reshape(n, 3, 3).to(r.covariance.dtype),
        converged=rows[:, 14] > 0.5,
    )


def _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses):
    return base(
        _gather_scan(store, src_idx, dirs), store_valid[src_idx],
        _gather_scan(store, tgt_idx, dirs), store_valid[tgt_idx],
        guesses,
    )


def make_batched_matcher(cfg: SLAMConfig, mesh: Mesh | None = None):
    """Batched PL-ICP matcher over (B, N, 2) pair batches:
    f(src_pts, src_valid, tgt_pts, tgt_valid, guesses) → PLICPResult."""
    base = _match_fn(cfg)
    if mesh is None:
        return base

    def f(sp, sv, tp, tv, g):
        return _gathered(base(*(block(t, mesh) for t in (sp, sv, tp, tv, g))),
                         mesh)

    return f


def make_indexed_matcher(cfg: SLAMConfig, mesh: Mesh | None = None):
    """Batched PL-ICP over a scan table: pairs are (src_idx, tgt_idx) rows
    into one (U, N, 2) points store, gathered on the device, so that each
    scan crosses to the device once however many pairs name it:
    f(store_pts, store_valid, src_idx, tgt_idx, guesses) → PLICPResult."""
    base = _match_fn(cfg)

    def f(store_pts, store_valid, src_idx, tgt_idx, guesses):
        if mesh is not None:
            src_idx, tgt_idx, guesses = (block(t, mesh) for t in
                                         (src_idx, tgt_idx, guesses))
        r = base(store_pts[src_idx], store_valid[src_idx],
                 store_pts[tgt_idx], store_valid[tgt_idx], guesses)
        return r if mesh is None else _gathered(r, mesh)

    return f


def make_packed_indexed_matcher(cfg: SLAMConfig, mesh: Mesh | None = None):
    """Matcher over a scan store by row index; returns ONE (B, 14) float32
    tensor ``[pose(3), error(1), num_inliers(1), covariance.flat(9)]``."""
    base = _match_fn(cfg)

    def f(store, store_valid, dirs, src_idx, tgt_idx, guesses):
        if mesh is not None:
            src_idx, tgt_idx, guesses = (block(t, mesh) for t in
                                         (src_idx, tgt_idx, guesses))
        out = _pack_result(
            _indexed(base, store, store_valid, dirs, src_idx, tgt_idx, guesses)
        )
        return out if mesh is None else all_gather_rows(out, mesh)

    return f


def make_sharded_training_step(mesh: Mesh, cfg: SLAMConfig):
    """The distributed SLAM step:

    step(src_pts (B, N, 2), src_valid, tgt_pts, tgt_valid, guesses (B, 3),
         poses (B+1, 3), lam) → (new_poses (B+1, 3), match_errors (B,))

    The B pairs are matched data-parallel (each rank its block); their
    relative poses become chain edges i → i+1 (information I·inliers),
    sharded the same way for the normal equations, whose edge terms one
    gather brings to every rank (``solver/distributed``); the dense solve
    runs replicated. B must tile the mesh."""
    base = _match_fn(cfg)

    def step(src_pts, src_valid, tgt_pts, tgt_valid, guesses, poses, lam):
        B = src_pts.shape[0]
        M = B + 1
        dev, dt = poses.device, poses.dtype
        res = base(*(block(t, mesh) for t in (src_pts, src_valid, tgt_pts,
                                               tgt_valid, guesses)))
        gi = torch.arange(B, device=dev)
        w = torch.clamp(res.num_inliers.to(dt), min=1.0)
        infos = torch.eye(3, dtype=dt, device=dev)[None] * w[:, None, None]
        sh = EdgeShard(block(gi, mesh), block(gi, mesh) + 1, res.pose.to(dt),
                       infos, gi, gi + 1, slot_table(gi, gi + 1, M))
        Hd, Hij, b = normal_equations(mesh, poses, sh, dense=True)
        free = torch.arange(M, device=dev) > 0
        new = poses + dense_solve(Hd, Hij, gi, gi + 1, b, lam, free)
        th = torch.atan2(torch.sin(new[:, 2]), torch.cos(new[:, 2]))
        new = torch.cat([new[:, :2], th[:, None]], dim=-1)
        return new, all_gather_rows(res.error, mesh)

    return step


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
