"""The readings that a cell's limits are set from: on each seed, the
program's worst number over one request of each pool entry, and the
control's (the reference in bfloat16 put in the program's place) on the
same entries; and, on the ``--fault-seeds``, the program's readings with
each of ``--faults`` (``faults.py``) planted. One process for all seeds,
so that set-up is paid once.

    python3 slam_bench/calibrate.py --workload <name> --seeds <n> [<n> ...]
        [--faults <fault> ...] [--fault-seeds <n> ...]

Prints one JSON line a seed ({"seed", "program", "control"}), one a fault
and seed ({"seed", "fault", "program"}) and, last, the largest program
reading, the smallest control reading and the smallest reading of each
fault, number by number. Needs a CUDA card; the benchmark's own runs do
not run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from slam_bench import faults, harness, spec

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    cell = spec.load_cell(ROOT, args.workload)
    request = spec.load_module(cell.dirs, "requests", cell.traffic["request"])
    hi, lo, flo = {}, {}, {}
    for seed in dict.fromkeys(args.seeds + args.fault_seeds):
        t = time.perf_counter()
        drv = request.Driver(cell.config, cell.traffic, seed, "cuda")
        drv.warm()
        if seed in args.seeds:
            kept = {k: drv.serve(k) for k in range(len(drv.pool))}
            acc, prog = harness.judge_all(drv, kept)
            _acc, ctrl = harness.judge_all(drv, kept, control=True,
                                           accounts=acc)
            for name in prog:
                hi[name] = max(hi.get(name, 0.0), prog[name])
                lo[name] = min(lo.get(name, float("inf")), ctrl[name])
            print(json.dumps({"seed": seed, "program": prog, "control": ctrl,
                              "seconds": time.perf_counter() - t}), flush=True)
        for fault in args.faults if seed in args.fault_seeds else ():
            t = time.perf_counter()
            with faults.FAULTS[fault]():
                kept = {k: drv.serve(k) for k in range(len(drv.pool))}
            _acc, prog = harness.judge_all(drv, kept)
            low = flo.setdefault(fault, {})
            for name in prog:
                low[name] = min(low.get(name, float("inf")), prog[name])
            print(json.dumps({"seed": seed, "fault": fault, "program": prog,
                              "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"program_max": hi, "control_min": lo,
                      "fault_min": flo}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
