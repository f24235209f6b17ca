"""Run one cell of the benchmark once and print its result line.

    python3 slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the program (``tpu_slam_torch``).
Needs a CUDA card (as many as the cell asks for); without one it exits
with code 2 and prints no result. ``--trace 1`` runs the window under the
device profiler and reports the cell's per-layer metrics, ``--trace 0``
its end-to-end ones. The last line on standard output is the JSON result;
the numbers compared with the reference are the last lines on standard
error. The program's kernels build into ``build/`` inside the checkout, so
only the first run of a checkout compiles.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BUILD = ROOT / "build"
# one process, one host thread: the program's host work is serial, and
# idle OpenMP and BLAS threads spin against it on a shared host
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
# every build and kernel cache in the checkout, at fixed paths
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the measuring process
FOREIGN = ("jax", "jaxlib", "flax", "tpu_slam")


def foreign_modules() -> list:
    """The forbidden top-level names among the loaded modules, compared
    whole (``tpu_slam_torch`` is not ``tpu_slam``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FOREIGN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from slam_bench import spec

    cell = spec.load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"slam_bench: the cell needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        from tpu_slam_torch import _build
    except ImportError as e:
        print(f"slam_bench: the program is not in this checkout: {e}",
              file=sys.stderr)
        return 3
    _build.BUILD_DIR = BUILD / "tpu_slam_torch"
    torch.set_num_threads(1)
    from slam_bench import harness

    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = foreign_modules()
    if found:
        print(f"slam_bench: the measuring process loaded {found}",
              file=sys.stderr)
        return 4
    harness.print_result(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
