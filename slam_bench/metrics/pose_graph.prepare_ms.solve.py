"""Per solve: the program's spans ``pose_graph.route`` (the route and the
RCM band spec), ``pose_graph.pack`` (host arrays) and ``pose_graph.upload``
(host → device copies), ms, over its counter ``pose_graph.solves``. Read
in traced runs; nothing where the program has no such spans."""

SPANS = ("pose_graph.route", "pose_graph.pack", "pose_graph.upload")


def read(run):
    if run.trace is None:
        return None
    totals, counts = run.stages["totals"], run.stages["counts"]
    solves = counts.get("pose_graph.solves", 0)
    if not solves or not all(s in totals for s in SPANS):
        return None
    return 1e3 * sum(totals[s] for s in SPANS) / solves
