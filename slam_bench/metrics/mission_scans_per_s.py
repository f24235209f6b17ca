"""Scans of every mission completed in the window over the window's
seconds."""


def read(run):
    return run.work / run.window_s if run.done else None
