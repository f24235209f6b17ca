"""The offline driver's loop-candidate sweep (``ops/cuda/loop_sweep``) on
the CPU: its plain version against the reference's
``tpu_slam.models.offline._loop_candidates``, and a model of the kernel's
two launches (``csrc/loop_sweep.cu``) against the plain version.

The reference orders the in-radius pairs with numpy's default ``argsort``,
which is not stable: among pairs of equal float32 distance (frequent, the
distance being a difference of squared norms) its order is the sort's.
The port orders by (d2, i, j). The reference is compared here with the
ties of that sort settled so: its ``np.argsort`` of the distances becomes
a sort on (d2, i, j) over the pair indices it concatenated just before
(``settled_reference``); nothing else of it changes."""

import dataclasses
import re
from fractions import Fraction
from unittest import mock

import numpy as np
import pytest
import torch

from tpu_slam.models import offline as joff
from tpu_slam_torch import _build, _dispatch
from tpu_slam_torch.models import offline as toff
from tpu_slam_torch.ops.cuda import loop_sweep as ls

from loop_sweep_cases import corridor_mission, poses_case, tried_for

_concatenate = np.concatenate


def settled_reference(poses, ocfg, tried):
    """The reference's candidates, its sort's ties settled by (i, j): it
    concatenates the pairs' i, j and d2, in that order, and sorts the
    d2."""
    joined = []

    def concatenate(arrays, *args, **kwargs):
        joined.append(_concatenate(arrays, *args, **kwargs))
        return joined[-1]

    def argsort(d2, *args, **kwargs):
        ii, jj, dd = joined[-3:]
        assert dd is d2
        return np.lexsort((jj, ii, d2))

    with mock.patch.object(np, "concatenate", concatenate), \
            mock.patch.object(np, "argsort", argsort):
        return joff._loop_candidates(poses, ocfg, tried)


CASES = ["corridor_true", "corridor_odom", "corridor_noisy", "random_ragged",
         "blockwise"]


def ocfg_for(cap):
    cfg = corridor_mission()[0]
    return dataclasses.replace(cfg.offline, max_candidates=cap,
                               loop_radius=1.5)


def reference_pass(ocfg):
    """The settled reference's picks with nothing tried and no cap."""
    uncapped = dataclasses.replace(ocfg, max_candidates=10_000)
    return lambda poses: settled_reference(poses, uncapped, set())


@pytest.mark.parametrize("cap", [4, 10_000], ids=["cap_reached",
                                                   "cap_not_reached"])
@pytest.mark.parametrize("tried_kind", ["none", "some"])
@pytest.mark.parametrize("case", CASES)
def test_plain_equals_reference(case, tried_kind, cap):
    poses = poses_case(case)
    ocfg = ocfg_for(cap)
    tried = tried_for(poses, tried_kind, reference_pass(ocfg))
    want = settled_reference(poses, ocfg, tried)
    got, live = ls.loop_sweep_plain(
        torch.as_tensor(poses, dtype=torch.float32), ocfg.loop_radius,
        ocfg.loop_min_gap, ocfg.loop_nms_gap, ocfg.max_candidates, tried)
    assert got == want
    assert (len(got) == cap) == (cap == 4)
    assert len(got) > 1 and live >= len(got)
    assert not tried & set(got)


def _exact_candidates(xy, radius, min_gap, gap, cap, tried):
    """The semantics written out with exact distances: every pair in
    (d2, i, j) order, the first of each cell, the reference's walk."""
    T = len(xy)
    pairs = sorted(
        (Fraction(float(xy[i, 0] - xy[j, 0])) ** 2
         + Fraction(float(xy[i, 1] - xy[j, 1])) ** 2, i, j)
        for i in range(T) for j in range(T) if j - i >= min_gap)
    seen, picked = set(), []
    for d2, i, j in pairs:
        cell = (i // gap, j // gap)
        if d2 > radius ** 2 or cell in seen:
            continue
        seen.add(cell)
        if (i, j) in tried or any(abs(i - a) < gap and abs(j - b) < gap
                                  for a, b in picked):
            continue
        picked.append((i, j))
        if len(picked) >= cap:
            break
    return picked


def test_tie_order_is_d2_then_i_then_j():
    """Scans k, k + 30 and k + 60 at the same place (on a line, at
    multiples of 0.5 m: every distance exact in float32): the pairs at
    distance 0 tie, and the cells' nearest pairs are their least (i, j)."""
    poses = poses_case("duplicates")
    got, _ = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                                 2.0, 20, 10, 40, set())
    assert got[:9] == [(0, 30), (0, 60), (10, 40), (10, 70), (20, 50),
                       (20, 80), (30, 60), (40, 70), (50, 80)]
    assert got == _exact_candidates(poses, 2, 20, 10, 40, set())
    tried = {(0, 30), (10, 70)}
    got, _ = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                                 2.0, 20, 10, 40, tried)
    assert got == _exact_candidates(poses, 2, 20, 10, 40, tried)
    assert (0, 30) not in got and (1, 31) not in got  # the cell yields none


def _order_bits(d2: np.ndarray) -> np.ndarray:
    u = d2.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u >> 31 == 1, u ^ 0xFFFFFFFF, u | 0x80000000)


def kernel_model(poses, radius, min_gap, gap, max_candidates, tried):
    """``csrc/loop_sweep.cu`` step by step in numpy: each cell's least key
    ((order bits of d2) << 32 | i T + j, EMPTY where none), the tried
    winners emptied, the live keys sorted, and warp 0's walk 32 keys at a
    time: neighbour cells' picks, the lanes' conflict masks, the picks in
    lane order up to the cap."""
    EMPTY = np.uint64(2 ** 64 - 1)
    PICKED = np.uint64(0xFFFFFFFE)
    T = len(poses)
    g = min(max(gap, 1), T)
    gap = min(max(gap, 0), T + 1)
    nc = -(-T // g)
    cap = min(max(max_candidates, 1), nc * nc)
    xy = torch.as_tensor(poses[:, :2], dtype=torch.float32)
    ii, jj, dd = ls._pairs(xy, ls.radius2(radius), min_gap)
    ii, jj = ii.numpy(), jj.numpy()
    keys = (_order_bits(dd.numpy()) << np.uint64(32)) | (
        ii.astype(np.uint64) * np.uint64(T) + jj.astype(np.uint64))
    cells = np.full(nc * nc, EMPTY, np.uint64)
    np.minimum.at(cells, (ii // g) * nc + jj // g, keys)
    cleared = 0
    for a, b in tried:
        if 0 <= a < T and 0 <= b < T:
            c = (a // g) * nc + b // g
            if cells[c] != EMPTY and int(cells[c]) & 0xFFFFFFFF == a * T + b:
                cells[c] = EMPTY
                cleared += 1
    live = np.sort(cells[cells != EMPTY])
    n = len(live)
    out, picks = [], 0
    for base in range(0, n, 32):
        if picks >= cap:
            break
        lanes = [int(k) & 0xFFFFFFFF for k in live[base:base + 32]]
        ij = [(p // T, p % T) for p in lanes]
        alive = []
        for i, j in ij:
            ok = True
            for di in (-1, 0, 1):
                for dj in (-1, 0, 1):
                    ni, nj = i // g + di, j // g + dj
                    if (di, dj) == (0, 0) or not (0 <= ni < nc
                                                  and 0 <= nj < nc):
                        continue
                    v = int(cells[ni * nc + nj])
                    if v >> 32 == int(PICKED):
                        a, b = divmod(v & 0xFFFFFFFF, T)
                        ok &= not (abs(i - a) < gap and abs(j - b) < gap)
            alive.append(ok)
        conflict = [sum(1 << m for m in range(k)
                        if abs(i - ij[m][0]) < gap and abs(j - ij[m][1]) < gap)
                    for k, (i, j) in enumerate(ij)]
        take = 0
        for m in range(len(ij)):
            if alive[m] and not conflict[m] & take and picks < cap:
                take |= 1 << m
                picks += 1
        for m, (i, j) in enumerate(ij):
            if take >> m & 1:
                out.append((i, j))
                cells[(i // g) * nc + j // g] = (PICKED << np.uint64(32)) | \
                    np.uint64(lanes[m])
    return out, n + cleared


@pytest.mark.parametrize("tried_kind", ["none", "some"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_model_equals_plain(case, tried_kind):
    poses = poses_case(case)
    ocfg = ocfg_for(128)
    tried = tried_for(poses, tried_kind, reference_pass(ocfg))
    args = (ocfg.loop_radius, ocfg.loop_min_gap, ocfg.loop_nms_gap,
            ocfg.max_candidates, tried)
    assert kernel_model(poses, *args) == ls.loop_sweep_plain(
        torch.as_tensor(poses, dtype=torch.float32), *args)


@pytest.mark.parametrize("radius, min_gap, gap, cap", [
    (2.0, 20, 10, 40), (2.0, -5, 10, 40), (2.0, 20, 0, 40), (2.0, 20, 1, 40),
    (2.0, 20, 200, 40), (2.0, 20, 10, 0), (0.0, 20, 10, 40),
])
def test_kernel_model_equals_plain_at_the_edges(radius, min_gap, gap, cap):
    """Duplicated poses; a gap below 1 (no suppression, cells of one pair),
    a gap past T (one cell), a negative minimum gap (pairs with i >= j),
    no cap and a zero radius, against the semantics written out."""
    poses = poses_case("duplicates")
    args = (radius, min_gap, gap, cap, {(0, 30)})
    plain = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                                *args)
    assert kernel_model(poses, *args) == plain
    if gap >= 1:
        assert plain[0] == _exact_candidates(poses, radius, min_gap, gap,
                                             max(cap, 1), args[-1])


def test_port_candidates_take_the_plain_route_and_count_cells():
    """``models/offline._loop_candidates`` on numpy poses: the plain
    version, no launch, its live cells counted in the open stage."""
    from tpu_slam_torch.utils.profiling import StageTimer

    poses = poses_case("corridor_odom")
    ocfg = ocfg_for(128)
    before = dict(_dispatch.LAUNCHES)
    timer = StageTimer()
    with timer.stage("candidates"):
        got = toff._loop_candidates(poses, ocfg, set())
    assert _dispatch.LAUNCHES == before
    want, live = ls.loop_sweep_plain(
        torch.as_tensor(poses, dtype=torch.float32), ocfg.loop_radius,
        ocfg.loop_min_gap, ocfg.loop_nms_gap, ocfg.max_candidates, set())
    assert got == want and timer.counts["offline.sweep_cells"] == live > 0


def test_offline_slam_counts_sweep_cells_in_candidates():
    """A mission on the CPU: each ``candidates`` stage counts its sweep's
    live cells, and no kernel launches."""
    from tpu_slam_torch.utils.profiling import StageTimer

    cfg, scans, _gt, odom = corridor_mission()
    timer = StageTimer()
    before = dict(_dispatch.LAUNCHES)
    toff.offline_slam(scans, cfg, odom=odom, timer=timer)
    assert _dispatch.LAUNCHES == before
    assert timer.counts["candidates"] >= 1
    assert timer.counts["offline.sweep_cells"] >= timer.counts["candidates"]


def test_kernel_source_agrees_with_the_wrapper():
    """The scan limit the wrapper mirrors, the C entry point's arity, and
    the two kernels named for the launch counter's key."""
    src = (_build.CSRC / "loop_sweep.cu").read_text()

    assert f"T > {ls.MAX_SCANS}" in src
    assert f"nc * nc > {ls.MAX_CELLS:#x}" in src
    params = re.search(r'extern "C" int loop_sweep_launch\((.*?)\)\s*\{',
                       src, re.S)[1].split(",")
    assert len(params) == len(_build.SIGNATURES["loop_sweep"][1])
    assert set(re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)",
                          src)) == {"loop_sweep_cells_kernel",
                                    "loop_sweep_select_kernel"}
    assert "loop_sweep" in _dispatch.LAUNCHES


def test_cuda_wrapper_refuses_what_the_kernel_cannot_take():
    big = torch.zeros((ls.MAX_SCANS + 1, 3))
    with pytest.raises(ValueError, match="at most"):
        ls.loop_sweep_cuda(big, 2.0, 40, 10, 128, set())
    with pytest.raises(ValueError, match="expected"):
        ls.loop_sweep_cuda(torch.zeros(5), 2.0, 40, 10, 128, set())
    with pytest.raises(ValueError, match="index cells"):
        ls.loop_sweep_cuda(torch.zeros((30_000, 3)), 2.0, 40, 1, 128, set())
