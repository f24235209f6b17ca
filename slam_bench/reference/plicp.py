"""Point-to-line ICP as CSM's ``sm_icp`` runs it with the lessons' settings:
per round an exhaustive nearest neighbour over the valid targets, the
better of j1 ± 1 as the segment's second point, the two trimming quantiles
(``outliers_maxPerc`` and ``outliers_adaptive_mult`` × the
``outliers_adaptive_order`` one), two Gauss-Newton steps on the frozen
correspondences; a pair freezes once its step is under the epsilons. The
covariance is σ²·(H + 1e-6·I)⁻¹ of the last step's normal matrix.

Plain PyTorch, written from the algorithm; ``dtype`` is the precision of
every elementwise step (the 3×3 solves run in float32 at least, as torch
has no lower-precision solve)."""

from __future__ import annotations

import torch

BIG = 1e12


def _apply(pose, pts):
    c, s = torch.cos(pose[:, 2])[:, None], torch.sin(pose[:, 2])[:, None]
    x, y = pts[..., 0], pts[..., 1]
    return torch.stack([c * x - s * y + pose[:, 0:1],
                        s * x + c * y + pose[:, 1:2]], -1)


def _rows(x, idx):
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _quantile(err, mask, q):
    """Per row the masked value at floor(q·(count − 1)) of the sorted ones
    (q·(count − 1) in float32)."""
    xs = torch.sort(torch.where(mask, err, torch.full_like(err, BIG)),
                    -1).values
    cnt1 = torch.clamp(mask.sum(-1) - 1, min=0).to(torch.float32)
    pos = torch.floor(torch.tensor(q, dtype=torch.float32) * cnt1)
    pos = torch.clamp(pos.to(torch.int64), 0, err.shape[-1] - 1)
    return torch.take_along_dim(xs, pos[:, None], -1)[:, 0]


def _gn_step(pose, src_w, q1, n, w):
    rp = src_w - pose[:, None, :2]
    j_th = (n * torch.stack([-rp[..., 1], rp[..., 0]], -1)).sum(-1)
    J = torch.cat([n, j_th[..., None]], -1)
    r = (n * (src_w - q1)).sum(-1)
    Jw = J * w[..., None]
    solve_t = torch.promote_types(pose.dtype, torch.float32)
    H = (Jw.transpose(-1, -2) @ J).to(solve_t)
    H = H + 1e-9 * torch.eye(3, dtype=solve_t, device=H.device)
    b = -(Jw.transpose(-1, -2) @ r[..., None]).to(solve_t)
    delta = torch.linalg.solve_ex(H, b)[0][..., 0].to(pose.dtype)
    ok = (w.sum(-1) >= 3) & torch.isfinite(delta).all(-1)
    delta = torch.where(ok[:, None], delta, torch.zeros_like(delta))
    th = pose[:, 2] + delta[:, 2]
    new = torch.stack([pose[:, 0] + delta[:, 0], pose[:, 1] + delta[:, 1],
                       torch.atan2(torch.sin(th), torch.cos(th))], -1)
    return new, delta, H


def _prepare(src, sv, tgt, tv, dtype):
    zero = torch.zeros((), dtype=dtype, device=src.device)
    src = torch.where(sv[..., None] & torch.isfinite(src), src.to(dtype), zero)
    tgt = torch.where(tv[..., None] & torch.isfinite(tgt), tgt.to(dtype), zero)
    return src, tgt


def _round(pose, src, sv, tgt, tv, p: dict):
    """One round's correspondences at ``pose``: the source points in the
    target's frame, each one's nearest valid target q1, the normal n of
    the segment to the better of j1 ± 1, |residual| and the trimmed
    weights."""
    M = tgt.shape[1]
    big = torch.tensor(BIG, dtype=torch.float32, device=src.device)
    src_w = _apply(pose, src)
    d2 = ((src_w[:, :, None, :] - tgt[:, None, :, :]) ** 2).sum(-1)
    d2 = torch.where(tv[:, None, :], d2.to(torch.float32), big)
    j1 = d2.argmin(-1)
    best = torch.take_along_dim(d2, j1[..., None], -1)[..., 0]
    q1 = _rows(tgt, j1)
    gate = sv & (best < p["max_correspondence_dist"] ** 2)
    gate &= torch.take_along_dim(tv, j1, -1)
    lo, hi = (j1 - 1).clamp(0, M - 1), (j1 + 1).clamp(0, M - 1)

    def d2_at(j):
        d = ((src_w - _rows(tgt, j)) ** 2).sum(-1).to(torch.float32)
        ok = torch.take_along_dim(tv, j, -1) & (j != j1)
        return torch.where(ok, d, big)

    j2 = torch.where(d2_at(lo) <= d2_at(hi), lo, hi)
    tang = _rows(tgt, j2) - q1
    tlen = torch.linalg.vector_norm(tang.to(torch.float32), dim=-1)
    gate &= (tlen > 1e-9) & torch.take_along_dim(tv, j2, -1)
    tang = tang / torch.clamp(tlen, min=1e-9)[..., None].to(src.dtype)
    n = torch.stack([-tang[..., 1], tang[..., 0]], -1)
    e = (n * (src_w - q1)).sum(-1).abs()
    q_perc = _quantile(e, gate, p["outliers_maxPerc"])
    q_adap = _quantile(e, gate, p["outliers_adaptive_order"])
    thr = torch.minimum(q_perc, torch.clamp(
        p["outliers_adaptive_mult"] * q_adap, min=1e-6))
    w = (gate & (e <= thr[:, None] + 1e-12)).to(src.dtype)
    return src_w, q1, n, e, w


def _block(src, sv, tgt, tv, init, p: dict, dtype):
    B = src.shape[0]
    src, tgt = _prepare(src, sv, tgt, tv, dtype)
    pose = init.to(dtype)
    conv = torch.zeros(B, dtype=torch.bool, device=src.device)
    rounds = torch.zeros(B, dtype=torch.int64, device=src.device)
    H = torch.zeros(B, 3, 3, dtype=torch.promote_types(dtype, torch.float32),
                    device=src.device)
    err = torch.zeros(B, dtype=dtype, device=src.device)
    ninl = torch.zeros(B, dtype=torch.int64, device=src.device)
    for _ in range(p["max_iterations"]):
        rounds += (~conv).to(torch.int64)
        src_w, q1, n, e, w = _round(pose, src, sv, tgt, tv, p)
        pose1, d1, _ = _gn_step(pose, src_w, q1, n, w)
        pose2, d2s, H2 = _gn_step(pose1, _apply(pose1, src), q1, n, w)
        err2 = (w * e).sum(-1) / torch.clamp(w.sum(-1), min=1.0)
        step = (d1 + d2s).to(torch.float32)
        pose = torch.where(conv[:, None], pose, pose2)
        err = torch.where(conv, err, err2)
        ninl = torch.where(conv, ninl, (w > 0).sum(-1))
        H = torch.where(conv[:, None, None], H, H2)
        conv = conv | ((step[:, 0].abs() < p["epsilon_xy"])
                       & (step[:, 1].abs() < p["epsilon_xy"])
                       & (step[:, 2].abs() < p["epsilon_theta"]))
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    cov = p["sigma"] ** 2 * torch.linalg.inv_ex(H + 1e-6 * eye)[0]
    return pose, err, ninl, cov, rounds


def trimmed_error(src, sv, tgt, tv, pose, params: dict):
    """The mean |point-to-line residual| of the trimmed inliers of each pair
    at ``pose`` (B, 3), float32, in one round's correspondences: what a
    match settled at ``pose`` reports as its error. Float64 host array."""
    s, t = _prepare(src, sv, tgt, tv, torch.float32)
    _sw, _q1, _n, e, w = _round(pose.to(torch.float32), s, sv, t, tv, params)
    return ((w * e).sum(-1) / torch.clamp(w.sum(-1), min=1.0)).double().cpu().numpy()


def plicp(src, sv, tgt, tv, init, params: dict, dtype=torch.float32,
          block: int = 128) -> dict:
    """Match each src scan (B, N, 2) into its tgt scan (B, M, 2) from
    ``init`` (B, 3); ``params`` are the configuration's PL-ICP settings.
    Returns float64 host arrays: pose (B, 3), error, inliers, covariance
    (B, 3, 3) and the rounds each pair ran."""
    out = []
    for a in range(0, src.shape[0], block):
        s = slice(a, a + block)
        out.append(_block(src[s], sv[s], tgt[s], tv[s], init[s], params,
                          dtype))
    keys = ("pose", "error", "inliers", "covariance", "rounds")
    return {k: torch.cat([o[i] for o in out]).double().cpu().numpy()
            for i, k in enumerate(keys)}
