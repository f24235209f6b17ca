"""Loop-closure candidate search over a mesh: the keyframe ring-pass —
port of ``tpu_slam/parallel/loop_search.py``.

The reference's loop search scans every stored scan against the current
pose (FindPossibleLoopClosure, Mapper.cpp:1333-1394). Here the keyframes
are sharded over the ranks and their blocks travel around the ring by
``ppermute``, so each rank holds K/D keyframes at a time while it fills
its rows of the (Q, K) query↔keyframe distance matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_slam_torch.parallel.mesh import Mesh, all_gather_rows, block, ppermute


def make_ring_loop_search(mesh: Mesh):
    """f(queries (Q, 2), keyframes (K, 2)) → (Q, K) squared distances, the
    global tensors in and out; each rank computes the rows of its block of
    the queries against every keyframe block as it passes. Q and K must
    tile the mesh (pad with far rows)."""
    D = mesh.size

    def f(queries, keyframes):
        if keyframes.shape[0] % D:
            raise ValueError(f"{keyframes.shape[0]} keyframes do not tile "
                             f"{D} ranks: pad them")
        q = block(queries, mesh)
        kf = block(keyframes, mesh)
        kb = kf.shape[0]
        out = torch.full((q.shape[0], kb * D), float("inf"), dtype=q.dtype,
                         device=q.device)
        perm = [(i, (i + 1) % D) for i in range(D)]
        for s in range(D):
            # the block held now started on rank (me − s) mod D
            src = (mesh.rank - s) % D
            out[:, src * kb:(src + 1) * kb] = (
                (q[:, None, 0] - kf[None, :, 0]) ** 2
                + (q[:, None, 1] - kf[None, :, 1]) ** 2)
            if s + 1 < D:
                kf = ppermute(kf, mesh, perm)
        return all_gather_rows(out, mesh)

    return f


def loop_candidates(
    d2: np.ndarray, max_distance: float, min_chain: int,
    exclude: set[int] | None = None,
) -> list[list[int]]:
    """Host-side chain extraction from one query row of the distance matrix
    — the consecutive-run logic of FindPossibleLoopClosure
    (Mapper.cpp:1350-1391): runs of keyframes within ``max_distance``,
    broken by excluded (near-linked) ids, kept if ≥ min_chain long."""
    exclude = exclude or set()
    chains = []
    chain: list[int] = []
    for i, v in enumerate(d2):
        if v < max_distance**2 + 1e-6:
            if i in exclude:
                chain = []
            else:
                chain.append(i)
        else:
            if len(chain) >= min_chain:
                chains.append(chain)
            chain = []
    if len(chain) >= min_chain:
        chains.append(chain)
    return chains
