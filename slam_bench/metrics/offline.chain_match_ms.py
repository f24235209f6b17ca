"""Per mission: the chain's PL-ICP batch, the ``chain_match`` stage of the
offline driver's ``StageTimer``."""


def read(run):
    return run.stage_ms_per_request("chain_match")
