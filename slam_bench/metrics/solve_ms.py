"""The window's milliseconds over the solves completed in it."""


def read(run):
    return 1e3 * run.window_s / run.done if run.done else None
