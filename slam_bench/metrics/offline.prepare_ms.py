"""Per mission: ``offline_slam``'s ``prepare`` stages (ms): the scans
read back, the scan store built and uploaded, the matchers, seeds and
loop selector built, the chain's statistics and the skip edges' gates.
Read in traced runs; nothing where the program has no such stage."""


def read(run):
    if run.trace is None or "prepare" not in run.stages["totals"]:
        return None
    return run.stage_ms_per_request("prepare")
