"""``pcg_lm``'s share of its roofline (%): the least time for the work that
``rooflines/pcg_lm.py`` counts, over the device time of the launches it
counts."""

from slam_bench.roofline import share


def read(run):
    return share(run, "pcg_lm")
