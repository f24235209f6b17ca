"""The work of each traced solve's ``cr_lm`` launches: one LM solve of the
request's graph, as ``_banded.py`` counts it."""

from slam_bench.rooflines import _banded


def count(run):
    return _banded.count(run, "cr_lm")
