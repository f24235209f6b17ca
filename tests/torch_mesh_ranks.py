"""Runs the port's multi-device layer in D gloo ranks on the CPU, one
process a rank: the part that ``tests/mp_worker.py`` plays for the JAX
package. Not a test file, and it imports no JAX.

``run(D, cases)`` (or ``Ranks(D, cases).result()``, which lets the caller
work while the ranks run) starts D processes of this file, each with one torch
thread (the tier-1 run already keeps six pytest workers busy). Rank 0
hosts the store that joins them (``multihost.initialize`` over
``tcp://localhost:PORT`` with a 60 s timeout; D = 1 joins a group of
one). Each rank builds ``make_mesh(D, device="cpu")``, runs every case
(a job of ``JOBS`` with its pickled keyword arguments: numpy inputs and
the port's config objects) and pickles its results. The parent waits
for them against its own deadline (``DEADLINE_S``), kills every rank
still running there, and raises with the ranks' output when a rank
fails or the deadline passes.

    python tests/torch_mesh_ranks.py RANK D PORT IN_PICKLE OUT_DIR
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

DEADLINE_S = 120.0
_HERE = Path(__file__).resolve()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """D ranks started on ``cases`` [(job name, kwargs), ...];
    ``result()`` waits for them (against the deadline, counted from the
    start) and returns each rank's list of results, in rank order."""

    def __init__(self, D: int, cases, deadline: float = DEADLINE_S):
        self.D, self.deadline = D, deadline
        self._tmp = tempfile.TemporaryDirectory()
        tmp = self.dir = Path(self._tmp.name)
        inp = tmp / "in.pkl"
        inp.write_bytes(pickle.dumps(list(cases)))
        port = _free_port()
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        root = str(_HERE.parent.parent)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p)
        self._logs = [open(tmp / f"rank{r}.log", "w+") for r in range(D)]
        self._procs = [subprocess.Popen(
            [sys.executable, str(_HERE), str(r), str(D), str(port), str(inp),
             str(tmp)], stdout=self._logs[r], stderr=subprocess.STDOUT,
            env=env, cwd=root) for r in range(D)]
        self._end = time.monotonic() + deadline

    def result(self) -> list[list]:
        procs, late = self._procs, False
        try:
            for p in procs:
                try:
                    p.wait(timeout=max(self._end - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    late = True
                    break
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for log in self._logs:
            log.seek(0)
            out.append(log.read())
            log.close()
        try:
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if late or failed:
                what = (f"passed the {self.deadline:.0f} s deadline" if late
                        else f"ranks {failed} failed")
                raise AssertionError(
                    f"{self.D} gloo ranks: {what}\n" + "\n".join(
                        f"--- rank {r} (rc {p.returncode}) ---\n"
                        f"{out[r][-4000:]}" for r, p in enumerate(procs)))
            return [pickle.loads((self.dir / f"rank{r}.pkl").read_bytes())
                    for r in range(self.D)]
        finally:
            self._tmp.cleanup()


def run(D: int, cases, deadline: float = DEADLINE_S) -> list[list]:
    """Run ``cases`` in D ranks and wait for them (``Ranks``)."""
    return Ranks(D, cases, deadline).result()


# --- the jobs: each runs on every rank, over the mesh -------------------


def job_collectives(mesh):
    import torch

    from tpu_slam_torch.parallel import mesh as pm
    from tpu_slam_torch.parallel.multihost import global_mesh

    D, r = mesh.size, mesh.rank
    pm.reset_collectives()
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10.0 * r
    ring = [(i, (i + 1) % D) for i in range(D)]
    return {
        "psum": pm.psum(x, mesh).numpy(),
        "ppermute": pm.ppermute(x, mesh, ring).numpy(),
        # rank 0 sends to itself only: every other rank receives zeros
        "ppermute_self": pm.ppermute(x, mesh, [(0, 0)]).numpy(),
        "gather": pm.all_gather_rows(x, mesh).numpy(),
        "shard": pm.shard_batch(mesh, torch.arange(4 * D)).numpy(),
        "counts": dict(pm.COLLECTIVES),
        "shape": mesh.shape,
        "repr": repr(mesh),
        "global": repr(global_mesh(device="cpu")),
    }


def job_matcher(mesh, cfg, sp, sv, tp, tv, g, store_idx):
    """The three sharded matchers on one pair batch: the batched matcher,
    the packed indexed matcher over a ranges-free points store (dirs
    unused) and the indexed matcher, the store holding the batch's
    scans at ``store_idx``."""
    import torch

    from tpu_slam_torch.parallel import distributed_step as ds

    t = torch.as_tensor
    res = ds.make_batched_matcher(cfg, mesh)(t(sp), t(sv), t(tp), t(tv),
                                             t(g))
    store_pts, store_valid, si, ti = store_idx
    packed = ds.make_packed_indexed_matcher(cfg, mesh)(
        t(store_pts), t(store_valid), torch.zeros(1, 2), t(si), t(ti), t(g))
    ind = ds.make_indexed_matcher(cfg, mesh)(t(store_pts), t(store_valid),
                                             t(si), t(ti), t(g))
    return {"pose": res.pose.numpy(), "error": res.error.numpy(),
            "inliers": res.num_inliers.numpy(),
            "cov": res.covariance.numpy(), "packed": packed.numpy(),
            "indexed": ind.pose.numpy()}


def job_lm_delta(mesh, args, M, cg_iters):
    import torch

    from tpu_slam_torch.solver import distributed as sd

    a = [torch.as_tensor(x) for x in args]
    a[6] = float(args[6])
    return {"dense": sd.make_distributed_lm_delta(mesh, M)(*a).numpy(),
            "cg": sd.make_distributed_cg_delta(mesh, M, cg_iters)(*a)
            .numpy()}


def job_schur_delta(mesh, args):
    """The submap-sharded Schur step at S = D (one submap a rank) of the
    graph ``args`` (poses, ei, ej, means, infos, mask, lam, free)."""
    import torch

    from tpu_slam_torch.solver.schur import (
        build_partition, make_distributed_schur_delta,
    )

    poses, ei, ej, _m, _i, mask, _l, _f = args
    part = build_partition(ei, ej, mask, len(poses), mesh.size)
    a = [torch.as_tensor(x) for x in args]
    a[6] = float(args[6])
    return make_distributed_schur_delta(mesh, part)(*a).numpy()


def job_ring_search(mesh, queries, kfs):
    import torch

    from tpu_slam_torch.parallel.loop_search import make_ring_loop_search

    return make_ring_loop_search(mesh)(torch.as_tensor(queries),
                                       torch.as_tensor(kfs)).numpy()


def job_logodds(mesh, gcfg, locfg, origin, endpoints, valid, max_range):
    import torch

    from tpu_slam_torch.parallel import mesh as pm
    from tpu_slam_torch.parallel.sharded_map import (
        make_sharded_logodds_update,
    )

    f = make_sharded_logodds_update(mesh, gcfg, locfg, max_range)
    t = torch.as_tensor
    stripe = f(pm.block(torch.zeros((gcfg.size_y, gcfg.size_x)), mesh),
               t(origin), t(endpoints), t(valid))
    return {"grid": pm.all_gather_rows(stripe, mesh).numpy(),
            "stripe": stripe.numpy()}


def job_hector_step(mesh, gcfg, prob, pose, pts, valid, n_iters=1):
    import torch

    from tpu_slam_torch.parallel.mesh import block
    from tpu_slam_torch.parallel.sharded_map import make_sharded_hector_step

    t = torch.as_tensor
    p, H = make_sharded_hector_step(mesh, gcfg, n_iters=n_iters)(
        block(t(prob), mesh), t(pose), t(pts), t(valid))
    return {"pose": p.numpy(), "H": H.numpy()}


def job_training_step(mesh, cfg, args):
    import torch

    from tpu_slam_torch.parallel.distributed_step import (
        make_sharded_training_step,
    )

    a = [torch.as_tensor(x) for x in args]
    a[6] = float(args[6])
    poses, errs = make_sharded_training_step(mesh, cfg)(*a)
    return {"poses": poses.numpy(), "errors": errs.numpy()}


def job_pose_graph(mesh, cfgs, init, edges, info, sharded=True):
    """PoseGraphSolver(mesh) on one graph under each solver config:
    (poses, stats, route, collectives)."""
    if not sharded:
        mesh = None
    from tpu_slam_torch.parallel import mesh as pm
    from tpu_slam_torch.solver.pose_graph import PoseGraphSolver, _route

    out = []
    for cfg in cfgs:
        s = (PoseGraphSolver(cfg, mesh=mesh) if mesh is not None
             else PoseGraphSolver(cfg, device="cpu"))
        s.add_nodes(range(len(init)), init)
        for i, j, m in edges:
            s.add_constraint(i, j, m, information=info)
        pm.reset_collectives()
        stats = s.compute()
        out.append((s.get_poses(), tuple(stats),
                    _route(s.num_nodes, s.num_edges, s.device, cfg,
                           s._band_spec, mesh),
                    dict(pm.COLLECTIVES)))
    return out


def _scans(fields):
    """A port Scan from the five fields of a JAX Scan (numpy)."""
    from tpu_slam_torch.convert import scan_from_numpy

    return scan_from_numpy(*fields, device="cpu")


def job_offline(mesh, cfg, fields, odom, sharded=True):
    from tpu_slam_torch.models.offline import offline_slam

    r = offline_slam(_scans(fields), cfg, odom=odom,
                     mesh=mesh if sharded else None)
    return {"poses": r.poses, "chain": r.chain_poses, "loops": len(r.loops),
            "tried": r.candidates_tried, "edges": r.solver.num_edges}


def job_karto(mesh, cfg, fields, odom, sharded=True):
    from tpu_slam_torch.models.karto.pipeline import KartoSLAM

    slam = (KartoSLAM(cfg, mesh=mesh) if sharded
            else KartoSLAM(cfg, device="cpu"))
    acc = slam.run(_scans(fields), odom)
    return {"accepted": list(acc), "closures": slam.loop_closures,
            "edges": slam.solver.num_edges,
            "trajectory": slam.trajectory()}


def job_hector(mesh, cfg, fields, pose0, sharded=True):
    import torch

    from tpu_slam_torch.models.hector_slam import HectorSLAM

    slam = (HectorSLAM(cfg, mesh=mesh) if sharded
            else HectorSLAM(cfg, device="cpu"))
    slam.last_pose = torch.as_tensor(np.asarray(pose0, np.float32))
    est = slam.run(_scans(fields))
    return {"est": est, "maps": [slam.to_ros_map(level=k)
                                 for k in range(len(slam.grid_cfgs))],
            "stripe_cells": [int(g.numel()) for g in slam.grids]}


def job_hang(mesh):
    """Rank 0 waits in a psum that no other rank joins: the fault a branch
    on a value that is not replicated makes."""
    import torch

    from tpu_slam_torch.parallel.mesh import psum

    if mesh.rank == 0:
        psum(torch.ones(1), mesh)
    else:
        time.sleep(600)


JOBS = {name[4:]: fn for name, fn in dict(globals()).items()
        if name.startswith("job_")}


def _main(argv) -> None:
    rank, D, port = int(argv[1]), int(argv[2]), int(argv[3])
    inp, out_dir = Path(argv[4]), Path(argv[5])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tpu_slam_torch.parallel import multihost
    from tpu_slam_torch.parallel.mesh import make_mesh

    if D == 1:  # a group of one: the collectives still make their calls
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=1,
            rank=0, timeout=multihost.INIT_TIMEOUT)
    else:
        multihost.initialize(f"localhost:{port}", D, rank, backend="gloo")
    mesh = make_mesh(D, device="cpu")
    results = [JOBS[name](mesh, **kw) for name, kw in
               pickle.loads(inp.read_bytes())]
    (out_dir / f"rank{rank}.pkl").write_bytes(pickle.dumps(results))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv)
