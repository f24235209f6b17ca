"""The device's idle share of the traced window (%): 1 − the union of its
operations' intervals over the window."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s(run.t0, run.t1) / run.window_s)
