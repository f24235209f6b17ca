"""The loop-candidate sweep's kernel (``csrc/loop_sweep.cu``) on the card
against its plain version (``ops/cuda/loop_sweep.loop_sweep_plain``), bit
for bit, and its launch and live-cell counters in ``offline_slam``.

Needs a CUDA card and skips without one. This file imports no JAX, so it
runs where the JAX package is absent, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_loop_sweep_card.py -q
"""

import pytest
import torch

from tpu_slam_torch import _dispatch
from tpu_slam_torch.models.offline import offline_slam
from tpu_slam_torch.ops.cuda import loop_sweep as ls
from tpu_slam_torch.utils.profiling import StageTimer

from loop_sweep_cases import corridor_mission, poses_case, tried_for


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


CASES = ["laps_exact", "laps_noisy", "random_ragged", "blockwise",
         "duplicates", "all_near", "long"]


def first_pass(poses):
    return ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                               2.0, 40, 10, 10_000, set())[0]


@pytest.mark.card
@pytest.mark.parametrize("cap", [4, 128, 10_000])
@pytest.mark.parametrize("tried_kind", ["none", "some"])
@pytest.mark.parametrize("case", CASES)
def test_kernel_equals_plain(card, case, tried_kind, cap):
    poses = poses_case(case)
    tried = tried_for(poses, tried_kind, first_pass)
    args = (2.0, 40 if case != "duplicates" else 20, 10, cap, tried)
    want = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                               *args)
    before = _dispatch.LAUNCHES["loop_sweep"]
    got = ls.loop_sweep(torch.as_tensor(poses, dtype=torch.float32,
                                        device=card), *args)
    assert _dispatch.LAUNCHES["loop_sweep"] == before + 1
    assert got == want


@pytest.mark.card
@pytest.mark.parametrize("tried_kind", ["none", "some"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_on_the_card_equals_the_cpu(card, case, tried_kind):
    """The plain version, which the dispatcher takes for a CPU tensor, also
    runs on card tensors (its time there is the kernel's yardstick) and
    gives the same picks and live cells."""
    poses = poses_case(case)
    tried = tried_for(poses, tried_kind, first_pass)
    args = (2.0, 40 if case != "duplicates" else 20, 10, 128, tried)
    want = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                               *args)
    got = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32,
                                              device=card), *args)
    assert got == want


@pytest.mark.card
@pytest.mark.parametrize("radius, min_gap, gap, cap", [
    (2.0, -5, 10, 40), (2.0, 20, 0, 40), (2.0, 20, 1, 40),
    (2.0, 20, 200, 40), (2.0, 20, 10, 0), (0.0, 20, 10, 40),
])
def test_kernel_equals_plain_at_the_edges(card, radius, min_gap, gap, cap):
    poses = poses_case("duplicates")
    args = (radius, min_gap, gap, cap, {(0, 30)})
    want = ls.loop_sweep_plain(torch.as_tensor(poses, dtype=torch.float32),
                               *args)
    got = ls.loop_sweep(torch.as_tensor(poses, device=card), *args)
    assert got == want


@pytest.mark.card
def test_offline_slam_launches_a_sweep_a_round(card):
    """Each ``candidates`` stage of a mission is one launch, and counts its
    live cells (``offline.sweep_cells``) in the open timer."""
    cfg, scans, _gt, odom = corridor_mission(card)
    timer = StageTimer()
    _dispatch.reset_launches()
    res = offline_slam(scans, cfg, odom=odom, timer=timer)
    torch.cuda.synchronize()
    assert timer.counts["candidates"] >= 1
    assert _dispatch.LAUNCHES["loop_sweep"] == timer.counts["candidates"]
    assert timer.counts["offline.sweep_cells"] >= timer.counts["candidates"]
    assert res.candidates_tried > 0
