"""LM iterations a solve: the program's counter ``pose_graph.lm_iterations``
(each solve's packed result, row 3, lane 3) over ``pose_graph.solves``.
Read in traced runs; nothing where the program has no such counters."""


def read(run):
    if run.trace is None:
        return None
    counts = run.stages["counts"]
    solves = counts.get("pose_graph.solves", 0)
    if not solves or "pose_graph.lm_iterations" not in counts:
        return None
    return counts["pose_graph.lm_iterations"] / solves
