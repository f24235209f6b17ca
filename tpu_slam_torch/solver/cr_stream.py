"""The doSPA LM solve of a banded pose graph with an exact block
cyclic-reduction step, at any power-of-two number of supernodes — port of
``tpu_slam/solver/cr_stream.py``.

``streamed_cr_lm`` keeps ``solver/cr_lm.fused_cr_lm``'s packed contract:
``pT8`` (8, W·K) with the poses in rows 0..2 (flat lane f = a·K + k for
chain position p = k·W + a) and the free mask in row 3, ``slots``
(NBANKS·W·SLOT_ROWS, W·K), and back the (8, W·K) result with the solved
poses in rows 0..2 and (cost0, cost, good, iters) in row 3, lanes 0..3.

On ``cuda`` it launches ``csrc/cr_stream.cu`` on the shape that
``stream_schedule`` gives: per LM iteration assembly, the wide levels
(more than ``CLUSTER_ACTIVE`` active supernodes) as grid launches a warp
per supernode, one thread-block cluster for the deep levels, the top solve
and their back-substitution, the wide levels' back-substitution, the
candidate, and its cost with the accept/reject step. The LM state stays on
the device; the wrapper returns once the host has read the device's
convergence flag after the last chunk of iterations it enqueued. On
``cpu`` it runs ``cr_lm.cr_lm_plain``, the same function as the
single-launch kernel's plain version: its ``cr_solve`` eliminates
supernodes h, 3h, 5h, … at level h, which is the pipeline's level order,
with the reference's compaction of the survivors done by strided indices.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.solver.cr_lm import (
    check_packed,
    cr_lm_plain,
    launch_geometry,
)

STATE_FLOATS = 16  # the LM state at the head of the scratch
BLOCK = 256  # threads of the kernel's per-lane blocks (cr_stream.cu)
LANES = 32  # flat lanes a block of its edge kernels (cr_stream.cu)
WIDE_WARPS = 4  # warps a block of the wide levels' kernels (cr_stream.cu)
# active supernodes at the level where the cluster takes over (it may take
# up to K_MAX); chip_sweep.py times 512, 256, 128 and 64
CLUSTER_ACTIVE = 128
# LM iterations enqueued between two reads of the device's done flag: at
# most CHUNK - 1 iterations' launches run after convergence
CHUNK = 4


@dataclass(frozen=True)
class StreamSchedule:
    """What the kernel launches for one solve at (W, K)."""

    K: int
    h0: int  # the first level the cluster runs
    cluster: tuple[int, int, int]  # (blocks, warps, shared bytes a block)
    lane_blocks: int  # blocks of the per-lane kernels (a thread a lane)
    edge_blocks: int  # blocks of the edge kernels (LANES lanes a block)
    chunk: int  # LM iterations between two reads of done

    @property
    def grid_levels(self) -> tuple[int, ...]:
        """The wide levels h < h0: an elimination and a fold launch each,
        and a back-substitution launch."""
        return tuple(1 << i for i in range(self.h0.bit_length() - 1))

    @property
    def cluster_levels(self) -> tuple[int, ...]:
        """The levels h0, 2·h0, …, K/2 that the cluster eliminates."""
        return tuple(self.h0 << i
                     for i in range((self.K // self.h0).bit_length() - 1))

    @property
    def per_iter(self) -> int:
        """Launches per LM iteration: assembly, (elimination, fold) per
        wide level, the cluster, a back-substitution per wide level, the
        candidate and its cost with the LM decision."""
        return 1 + 3 * len(self.grid_levels) + 1 + 2

    def wide_blocks(self, h: int) -> int:
        """Blocks of a wide level's launches: a warp per supernode."""
        return -(-(self.K // (2 * h)) // WIDE_WARPS)

    def iterations_enqueued(self, run: int, iters: int) -> int:
        """LM iterations the host enqueues when the solve stops after
        ``run`` of at most ``iters``: whole chunks up to the one in which
        it converged."""
        return min(iters, -(-max(run, 1) // self.chunk) * self.chunk)

    def kernels(self, run: int, iters: int) -> int:
        """Launches of a whole solve: the set-up, the enqueued iterations
        and the packing of the result."""
        return 2 + self.per_iter * self.iterations_enqueued(run, iters)


def stream_schedule(W: int, K: int) -> StreamSchedule:
    """The kernel's shape at band W and K supernodes: the cluster takes
    over at the level h0 = K / CLUSTER_ACTIVE where that many supernodes
    are left active (h0 = 1 up to K = CLUSTER_ACTIVE), sized as the
    single-launch kernel is at that many (``cr_lm.launch_geometry``)."""
    h0 = max(1, K // CLUSTER_ACTIVE)
    return StreamSchedule(K=K, h0=h0, cluster=launch_geometry(W, K // h0),
                          lane_blocks=-(-(W * K) // BLOCK),
                          edge_blocks=-(-(W * K) // LANES),
                          chunk=CHUNK)


def streamed_applicable(W: int, K: int) -> bool:
    """The shapes the kernel takes: K a power of two ≥ 128, W in 1..8 (a
    supernode of n = 3W ≤ 24 unknowns)."""
    return 1 <= W <= 8 and K >= 128 and K & (K - 1) == 0


def scratch_floats(W: int, K: int) -> int:
    """Float count of the kernel's device scratch (see cr_stream.cu): the
    LM state, two pose buffers, D, B and the stored eliminations X1, X2
    (n²·K each), r, Xr and x (n·K each), and the per-block partial sums
    of ‖δ‖² (a per-lane block each) and χ² (an edge block each)."""
    n, WK = 3 * W, W * K
    sched = stream_schedule(W, K)
    return (STATE_FLOATS + 6 * WK + 4 * n * n * K + 3 * n * K
            + sched.lane_blocks + sched.edge_blocks)


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
    sched = stream_schedule(W, K)
    out = torch.empty((8, WK), dtype=torch.float32, device=dev)
    scratch = torch.empty(scratch_floats(W, K), dtype=torch.float32,
                          device=dev)
    _build.launch(
        "cr_stream", pT8.data_ptr(), slots.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), float(lam0), W, K, iters, float(sq_min_delta),
        sched.h0, *sched.cluster, sched.chunk,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _dispatch.count_launch("cr_stream")
    return out
