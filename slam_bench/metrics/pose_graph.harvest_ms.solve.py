"""Per solve: the program's span ``pose_graph.harvest`` (the packed
result's unpacking and the poses' write-back, after the device → host
read), ms, over its counter ``pose_graph.solves``. Read in traced runs;
nothing where the program has no such span."""


def read(run):
    if run.trace is None:
        return None
    totals, counts = run.stages["totals"], run.stages["counts"]
    solves = counts.get("pose_graph.solves", 0)
    if not solves or "pose_graph.harvest" not in totals:
        return None
    return 1e3 * totals["pose_graph.harvest"] / solves
