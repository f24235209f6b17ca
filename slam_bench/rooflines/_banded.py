"""What the two cyclic-reduction kernels' counts share: the work of an LM
solve of a graph whose system bands under reverse Cuthill-McKee.

Each LM iteration the reference's float64 LM needs: ~440 operations an
edge for the normal equations and the candidate's cost, and a banded
Cholesky factor and two triangular solves of the n = 3M unknowns at the
half-bandwidth b = 3·(the RCM bandwidth in nodes + 1): n·b² + 4·n·b.
Bytes: the poses in and out, each edge's ends, mean and information
once."""

import numpy as np
import scipy.sparse as sp
from scipy.sparse.csgraph import reverse_cuthill_mckee


def rcm_bandwidth(ei, ej, M: int) -> int:
    a = sp.coo_matrix((np.ones(len(ei)), (ei, ej)), shape=(M, M)).tocsr()
    perm = reverse_cuthill_mckee(a + a.T, symmetric_mode=True)
    pos = np.empty(M, np.int64)
    pos[perm] = np.arange(M)
    return int(np.abs(pos[ei] - pos[ej]).max())


def count(run, key: str):
    ops = nbytes = seconds = 0.0
    cache = {}
    for k, s, e in run.requests:
        launches = run.trace.launches(key, s, e)
        if not launches or k not in run.accounts:
            continue
        if k not in cache:
            g = run.pool[k]
            M, E = len(g.init), len(g.ei)
            n, b = 3 * M, 3 * (rcm_bandwidth(g.ei, g.ej, M) + 1)
            it = run.accounts[k]["lm_iterations"]
            cache[k] = (it * (440.0 * E + n * b * b + 4.0 * n * b),
                        24.0 * M + 52.0 * E)
        ops += cache[k][0]
        nbytes += cache[k][1]
        seconds += sum(b - a for a, b in launches) / 1e6
    return (ops, nbytes, seconds) if seconds > 0 else None
