"""CG steps an LM iteration: the program's counter ``pose_graph.cg_steps``
(the PCG-LM's packed result, row 4, lane 0: every restart's steps) over
``pose_graph.lm_iterations``. Every solve of the mission takes the PCG-LM,
whose cap is ``cg_iterations`` × ``cg_restarts`` steps an LM iteration.
Read in traced runs; nothing where the program has no such counters."""


def read(run):
    if run.trace is None:
        return None
    counts = run.stages["counts"]
    its = counts.get("pose_graph.lm_iterations", 0)
    if not its or "pose_graph.cg_steps" not in counts:
        return None
    return counts["pose_graph.cg_steps"] / its
