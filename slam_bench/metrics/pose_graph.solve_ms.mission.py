"""Per mission: the pose-graph solves, the ``solve`` stage of the offline
driver's ``StageTimer`` (graph build, upload, kernel, harvest)."""


def read(run):
    return run.stage_ms_per_request("solve")
