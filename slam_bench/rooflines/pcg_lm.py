"""The work of every ``pcg_lm`` launch in each traced mission, each
counted as a solve of the mission's final graph (M nodes, E edges; an
earlier round's graph lacks a few loop edges).

Counted from the problem: the LM iterations the reference's float64 LM
needs on that graph, each with ~440 operations an edge (residual,
Jacobians, the three 3×3 blocks and gradient of JᵀΩJ, the candidate's
cost) and ``cg_iterations`` CG steps of 72 an edge (the two off-diagonal
block products) and 66 a node (diagonal block, block-Jacobi apply, the
vector updates). The CG steps are the configuration's cap, counted as
done whatever the kernel runs: a kernel that stops its CG sooner reads
as the same work done faster, and only the check of the poses holds it
to the answer. Bytes: the poses in and out, each edge's ends, mean and
information once."""


def count(run):
    ops = nbytes = seconds = 0.0
    cg = run.cell.config["solver"]["cg_iterations"]
    for k, s, e in run.requests:
        launches = run.trace.launches("pcg_lm", s, e)
        if not launches or k not in run.accounts:
            continue
        acc = run.accounts[k]
        E = len(acc["graph"][0])
        M = len(acc["poses"])
        per = acc["lm_iterations"] * (440.0 * E + cg * (72.0 * E + 66.0 * M))
        ops += per * len(launches)
        nbytes += (24.0 * M + 52.0 * E) * len(launches)
        seconds += sum(b - a for a, b in launches) / 1e6
    return (ops, nbytes, seconds) if seconds > 0 else None
