"""Request: one pose-graph solve on a fresh solver. ``PoseGraphSolver(cfg)``
→ ``add_nodes`` → ``add_constraints`` (information matrices) →
``compute()`` → ``get_poses()``. The unit of work is the solve."""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import program, traffic
from slam_bench.reference import graph as ref
from slam_bench.reference import lm

class Driver:
    def __init__(self, cfg: dict, traffic_params: dict, seed: int, device):
        from tpu_slam_torch.solver.pose_graph import PoseGraphSolver

        self._solver = PoseGraphSolver
        self.cfg_dict = cfg
        self.cfg = program.config(cfg)
        self.device = torch.device(device)
        self.pool = traffic.make_pool(traffic_params, seed)
        self.timer = program.span_timer()

    def warm(self) -> None:
        for k in range(len(self.pool)):
            self.serve(k)

    def serve(self, k: int) -> dict:
        gr = self.pool[k]
        with self.timer.stage("request.build"):
            s = self._solver(self.cfg.solver, device=self.device)
            s.add_nodes(range(len(gr.init)), gr.init)
            s.add_constraints(gr.ei, gr.ej, gr.means, informations=gr.infos)
        with self.timer.stage("request.compute"):
            s.compute()
        with self.timer.stage("request.get_poses"):
            poses = s.get_poses()
        return {"poses": poses}

    def work(self, k: int) -> int:
        return 1

    def reference(self, k: int, out: dict, control: bool = False) -> dict:
        return ref.account(self.pool[k], self.cfg_dict["solver"],
                           rounding=lm.bf16 if control else None)

    def judge(self, k: int, out: dict, account: dict) -> dict:
        return ref.judge(self.pool[k], out, account)

    def as_output(self, account: dict) -> dict:
        return {"poses": account["poses"]}
