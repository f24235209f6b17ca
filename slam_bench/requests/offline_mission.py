"""Request: one offline mission. Host ranges → ``make_scan`` →
``offline_slam(scans, cfg, odom=odom, timer=…)`` → the optimized poses on
the host. The unit of work is the scan."""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import program, traffic
from slam_bench.reference import mission as ref

class Driver:
    def __init__(self, cfg: dict, traffic_params: dict, seed: int, device):
        from tpu_slam_torch.data.scan import make_scan
        from tpu_slam_torch.models.offline import offline_slam

        self._make_scan, self._offline = make_scan, offline_slam
        self.cfg_dict = cfg
        self.cfg = program.config(cfg)
        self.device = torch.device(device)
        self.pool = traffic.make_pool(traffic_params, seed)
        self.timer = program.span_timer()

    def warm(self) -> None:
        """One mission of each pool entry: every kernel loaded, every
        batch shape of this traffic met once."""
        for k in range(len(self.pool)):
            self.serve(k)

    def serve(self, k: int) -> dict:
        m = self.pool[k]
        with self.timer.stage("request.make_scan"):
            scans = self._make_scan(m.ranges, self.cfg.scan, stamp=m.stamps,
                                    device=self.device)
        with self.timer.stage("request.offline_slam"):
            res = self._offline(scans, self.cfg, odom=m.odom, timer=self.timer)
        return {
            "poses": np.asarray(res.poses, np.float64),
            "chain_rels": np.asarray(res.chain_rels, np.float64),
            "loops": [{"i": e.i, "j": e.j, "mean": np.asarray(e.mean),
                       "cov": np.asarray(e.covariance),
                       "frac": e.inlier_frac} for e in res.loops],
        }

    def work(self, k: int) -> int:
        return len(self.pool[k].ranges)

    def reference(self, k: int, out: dict, control: bool = False) -> dict:
        """The reference's account of pool entry ``k`` for the loop edges
        of ``out``; with ``control``, the control's."""
        return ref.account(self.pool[k], out["loops"], self.cfg_dict,
                           self.device, control=control)

    def judge(self, k: int, out: dict, account: dict) -> dict:
        return ref.judge(self.pool[k], out, account, self.cfg_dict)

    def as_output(self, account: dict) -> dict:
        """The control's account in the form of the program's output."""
        return {"poses": account["poses"],
                "chain_rels": account["chain"]["pose"],
                "loops": [{"i": e["i"], "j": e["j"], "mean": p}
                          for e, p in zip(account["used"],
                                          account["loops"]["pose"])]}
