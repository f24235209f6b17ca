"""Per solve: its wall minus the time the device was busy inside it (ms),
from the device trace; the host's part of a solve: ingestion, routing,
packing, upload and harvest, and the launches' gaps."""


def read(run):
    if run.trace is None or not run.done:
        return None
    host = sum((e - s) - run.trace.busy_s(s, e) for _k, s, e in run.requests)
    return 1e3 * host / run.done
