"""Mission and Hector scans/s of one checkout, for comparing two commits
within one call on the card.

    python3 chip_rates.py LABEL

Runs ``chip_smoke``'s recipes from the checkout it is started in (its
``chip_smoke.py`` and ``tpu_slam_torch``): the bench mission through
``offline_slam`` and the 150-scan Hector run, each once to warm up and
then ``RUNS`` times. Prints one line, ``RATES`` and a JSON object with
the label, each run's scans/s (sorted) and their medians. To compare a
parent with a change on one card, copy this file into both checkouts
and run it in each, alternating: parent, change, change, parent.
Host-bound rates spread between calls, so compare only within one.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import torch

import chip_smoke as cs
from tpu_slam_torch.models.offline import offline_slam

RUNS = 5


def rates(run, scans: int) -> list[float]:
    """Scans/s of ``RUNS`` calls of ``run`` after a warm one."""
    out = []
    for i in range(RUNS + 1):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i:
            out.append(scans / (time.perf_counter() - t0))
    return sorted(out)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_rates.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg, scans, odom, gt = cs.bench_mission(dev)
    mission = rates(lambda: offline_slam(scans, cfg, odom=odom), len(gt))
    hcfg, hscans, hgt = cs.hector_seq(cs.HECTOR_SCANS, dev)
    hector = rates(lambda: cs.hector_run(hcfg, hscans, hgt, dev), len(hgt))
    print("RATES " + json.dumps({
        "label": sys.argv[1] if len(sys.argv) > 1 else "",
        "mission_scans_s": mission,
        "mission_median": statistics.median(mission),
        "hector_scans_s": hector,
        "hector_median": statistics.median(hector)}), flush=True)


if __name__ == "__main__":
    main()
