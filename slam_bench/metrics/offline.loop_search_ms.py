"""Per mission: the offline driver's loop search, the stages
``candidates`` + ``loop_match`` + ``pcm`` of its ``StageTimer`` (each ends
in a host read, so the host clock covers the device work)."""


def read(run):
    return run.stage_ms_per_request("candidates", "loop_match", "pcm")
