"""``plicp_fused``'s share of its roofline (%): the least time for the work that
``rooflines/plicp_fused.py`` counts, over the device time of the launches it
counts."""

from slam_bench.roofline import share


def read(run):
    return share(run, "plicp_fused")
