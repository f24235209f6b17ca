"""The work of ``plicp_fused``'s chain launch in each traced mission: the
first launch of the mission, every scan t + 1 matched into scan t.

Counted from the problem, not from the kernel's tiling or its padding to a
bucket: for each real pair, each round it needs (the rounds the
reference's PL-ICP runs on the same pair before its step falls under the
epsilons), 6 operations for each valid source against each valid target
(the exhaustive nearest neighbour: two differences, two products, a sum,
a compare) and ~122 for each valid source (second point, residual,
trimming select, the sums of two Gauss-Newton steps). Bytes: each pair's
points (8 B) and validity (1 B), its guess in, its 16-float result out.
A kernel that prunes the nearest-neighbour search reads against this same
exhaustive count."""

import numpy as np


def count(run):
    ops = nbytes = seconds = 0.0
    scan = run.cell.config["scan"]
    for k, s, e in run.requests:
        launches = run.trace.launches("plicp_fused", s, e)
        if not launches or k not in run.accounts:
            continue
        r = run.pool[k].ranges
        valid = np.isfinite(r) & (r > scan["range_min"]) & (r < scan["range_max"])
        nv = valid.sum(1).astype(np.float64)
        ns, mt = nv[1:], nv[:-1]
        rounds = run.accounts[k]["chain"]["rounds"]
        ops += float((rounds * (6.0 * ns * mt + 122.0 * ns)).sum())
        nbytes += len(ns) * (2 * r.shape[1] * 9 + 12 + 64)
        seconds += (launches[0][1] - launches[0][0]) / 1e6
    return (ops, nbytes, seconds) if seconds > 0 else None
