"""The reference's optimum of a pose graph the benchmark made, and the judge
of the program's solve of it.

The numbers compared:
  * ``pose_gap_m``: max distance of a solved pose from the reference's
    float64 optimum (node 0, the gauge, is held by both);
  * ``chi2_excess``: (χ² of the solved poses − the optimum's χ²) over the
    initial guess's χ², all evaluated here in float64: how much of the
    way to the optimum the solve left.
"""

from __future__ import annotations

import numpy as np

from slam_bench.reference import lm


def account(graph, solver_cfg: dict, rounding=None) -> dict:
    opt = lm.solve(graph.init, graph.ei, graph.ej, graph.means, graph.infos,
                   lam0=solver_cfg["initial_lambda"], rounding=rounding)
    return {"poses": opt["poses"], "chi2": opt["chi2"],
            "lm_iterations": opt["iterations"]}


def judge(graph, out: dict, ref: dict) -> dict:
    """``out``: the solve's poses (M, 3)."""
    args = (graph.ei, graph.ej, graph.means, graph.infos)
    c0 = lm.chi2(graph.init, *args)
    poses = np.asarray(out["poses"], np.float64)
    c = lm.chi2(poses, *args)
    return {
        "pose_gap_m": float(np.hypot(*(poses[:, :2] - ref["poses"][:, :2]).T).max()),
        "chi2_excess": (c - ref["chi2"]) / c0,
    }
