"""The doSPA LM solve of a banded pose graph with an exact block
cyclic-reduction step, at any power-of-two number of supernodes — port of
``tpu_slam/solver/cr_stream.py``.

``streamed_cr_lm`` keeps ``solver/cr_lm.fused_cr_lm``'s packed contract:
``pT8`` (8, W·K) with the poses in rows 0..2 (flat lane f = a·K + k for
chain position p = k·W + a) and the free mask in row 3, ``slots``
(NBANKS·W·SLOT_ROWS, W·K), and back the (8, W·K) result with the solved
poses in rows 0..2 and (cost0, cost, good, iters) in row 3, lanes 0..3.

On ``cuda`` it launches ``csrc/cr_stream.cu``: one train of grid-wide
kernels per solve (assembly, then per level an elimination and an update
kernel, the top solve, back-substitution, candidate, cost and the
accept/reject step), with the LM state on the device, so the host reads
nothing until the result. On ``cpu`` it runs ``cr_lm.cr_lm_plain``, the
same function as the single-launch kernel's plain version: its
``cr_solve`` eliminates supernodes h, 3h, 5h, … at level h, which is the
pipeline's level order, with the reference's compaction of the survivors
done by strided indices.
"""

from __future__ import annotations

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.solver.banded import NBANKS
from tpu_slam_torch.solver.cr_lm import STAGE_ROWS, check_packed, cr_lm_plain

STATE_FLOATS = 16  # the LM state at the head of the scratch
BLOCK = 256  # threads of the kernel's per-lane blocks (cr_stream.cu)


def streamed_applicable(W: int, K: int) -> bool:
    """The shapes the kernel takes: K a power of two ≥ 128, W in 1..8 (a
    supernode of n = 3W ≤ 24 unknowns)."""
    return 1 <= W <= 8 and K >= 128 and K & (K - 1) == 0


def scratch_floats(W: int, K: int) -> int:
    """Float count of the kernel's device scratch (see cr_stream.cu): the
    LM state, two pose buffers, the high-node staging rows, D, B and the
    stored eliminations X1, X2 (n²·K each), r, Xr and x (n·K each), and
    two rows of per-block partial sums."""
    n, WK = 3 * W, W * K
    nblk = -(-WK // BLOCK)
    return (STATE_FLOATS + 6 * WK + NBANKS * W * STAGE_ROWS * WK
            + 4 * n * n * K + 3 * n * K + 2 * nblk)


def streamed_cr_lm(pT8: torch.Tensor, slots: torch.Tensor, lam0: float, *,
                   W: int, K: int, iters: int,
                   sq_min_delta: float) -> torch.Tensor:
    """Run the whole LM solve; returns the packed (8, W·K) result."""
    if _dispatch.route(pT8) == "cpu":
        return cr_lm_plain(pT8, slots, lam0, W=W, K=K, iters=iters,
                           sq_min_delta=sq_min_delta)
    dev = pT8.device
    WK = W * K
    if not streamed_applicable(W, K):
        raise ValueError(f"streamed CR-LM kernel takes W in 1..8 and K a "
                         f"power of two ≥ 128, got W={W}, K={K}")
    check_packed(pT8, slots, W, K)
    out = torch.empty((8, WK), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(W, K), dtype=torch.float32,
                          device=dev)
    _build.launch(
        "cr_stream", pT8.data_ptr(), slots.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), float(lam0), W, K, iters, float(sq_min_delta),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("cr_stream")
    return out
