"""Per solve: the program's span ``pose_graph.ingest`` (``add_nodes`` and
``add_constraints``: the covariance inversions and the edge list, ms),
over its counter ``pose_graph.solves``. Read in traced runs; nothing where
the program has no such span."""


def read(run):
    if run.trace is None:
        return None
    totals, counts = run.stages["totals"], run.stages["counts"]
    solves = counts.get("pose_graph.solves", 0)
    if not solves or "pose_graph.ingest" not in totals:
        return None
    return 1e3 * totals["pose_graph.ingest"] / solves
