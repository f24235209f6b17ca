"""Per mission: ``offline_slam``'s ``graph_build`` stages (ms): each
``PoseGraphSolver`` built and filled with the mission's edges, the chain's
graph before any loop included. Read in traced runs; nothing where the
program has no such stage."""


def read(run):
    if run.trace is None or "graph_build" not in run.stages["totals"]:
        return None
    return run.stage_ms_per_request("graph_build")
