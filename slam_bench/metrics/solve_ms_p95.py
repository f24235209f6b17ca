"""The 95th percentile of every solve's latency in the window (ms)."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 95)) if run.done else None
