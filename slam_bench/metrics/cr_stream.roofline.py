"""``cr_stream``'s share of its roofline (%): the least time for the work that
``rooflines/cr_stream.py`` counts, over the device time of the launches it
counts."""

from slam_bench.roofline import share


def read(run):
    return share(run, "cr_stream")
