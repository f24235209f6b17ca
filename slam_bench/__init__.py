"""The benchmark of ``tpu_slam_torch`` on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed window and prints one JSON line:

    python slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, metric, kernel
count or cell lives in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<traffic>.json``,
``requests/<request>.py`` (the system-under-test driver and its check),
``metrics/<metric>.py``, ``rooflines/<kernel>.py``,
``limits/<workload>.json``. The plain reference that decides ``correct``
is in ``reference/`` and imports nothing of the program.
"""
