"""The table of peaks and a kernel's share of its roofline.

Published peaks of one NVIDIA H100 SXM (the data sheet's dense rates, at
its 700 W limit; the run reports the card's own power limit beside them).
A share is the least time the chip could take for the counted work, the
larger of operations over the float32 rate and bytes over the memory
rate, divided by the device time of the launches that did it."""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12  # float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def share(run, kernel: str):
    """``rooflines/<kernel>.py``'s count over the traced window, as a
    percentage of the device time of the launches it counts; None where
    the run has no trace or no such launch."""
    from slam_bench import spec

    if run.trace is None:
        return None
    counted = spec.load_module(run.cell.dirs, "rooflines", kernel).count(run)
    if counted is None:
        return None
    ops, nbytes, seconds = counted
    if seconds <= 0:
        return None
    return 100.0 * least_seconds(ops, nbytes) / seconds
