"""Port parity for the multi-device layer's modules: tpu_slam_torch's mesh,
collectives, sharded matchers, distributed LM and CG deltas, ring loop
search, striped log-odds update and Hector GN step, and the distributed
SLAM step, against tpu_slam's on the same seeded inputs.

The port's side runs in D gloo ranks on the CPU (``torch_mesh_ranks``:
one process a rank, one torch thread each, a deadline of its own); the
JAX side in this process on ``make_mesh(D)`` over the eight virtual CPU
devices of ``conftest.py``. Each comparison is the port at D against the
reference at the same D, and against the port's single-device result.
The tolerances are the reference's own (``tests/test_parallel.py``)."""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.config import GridConfig, LogOddsConfig, default_config
from tpu_slam.data import simulator as sim
from tpu_slam.data.scan import make_scan
from tpu_slam.parallel.mesh import make_mesh as jmake_mesh
from tpu_slam.parallel.mesh import replicated, shard_batch
from tpu_slam_torch.parallel import distributed_step as tds
from tpu_slam_torch.parallel import mesh as pm
from tpu_slam_torch.parallel.loop_search import loop_candidates
from tpu_slam_torch.solver import distributed as tsd

import torch_mesh_ranks as ranks
from test_parallel import ring
from test_schur import ring_graph as schur_ring
from test_torch_host_copies import port_config

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


# --- inputs, made once from numpy seeds ---------------------------------


@functools.lru_cache(maxsize=None)
def matcher_case():
    """tests/test_parallel.py's batch: 8 pairs of 90 beams, 4 rounds."""
    cfg = default_config()
    cfg = dataclasses.replace(
        cfg,
        scan=dataclasses.replace(cfg.scan, num_beams=90, range_max=6.0),
        plicp=dataclasses.replace(cfg.plicp, max_iterations=4),
    )
    B = 8
    traj = sim.circle_trajectory(B + 1, radius=1.2)
    world = sim.office_world(seed=3, size=8.0, clear_path=traj)
    seq = sim.simulate_sequence(world, traj, cfg.scan, seed=1)
    scans = make_scan(seq.ranges, cfg.scan)
    pts = np.where(np.asarray(scans.valid)[..., None],
                   np.asarray(scans.points()), 0.0).astype(np.float32)
    valid = np.asarray(scans.valid)
    rng = np.random.default_rng(5)
    g = (rng.normal(0, 0.02, (B, 3))).astype(np.float32)
    args = (pts[1:], valid[1:], pts[:-1], valid[:-1], g)
    store = (pts, valid, np.arange(1, B + 1), np.arange(0, B))
    return cfg, args, store, seq.gt_poses


@functools.lru_cache(maxsize=None)
def lm_case():
    """tests/test_parallel.py's 17-node ring, the edges padded to tile 8."""
    gt, ei, ej, means = ring(n=17)
    M, E = 17, 17
    pad = (-E) % 8
    Ep = E + pad
    eip = np.concatenate([ei, np.zeros(pad, np.int32)]).astype(np.int64)
    ejp = np.concatenate([ej, np.zeros(pad, np.int32)]).astype(np.int64)
    meansp = np.concatenate([means, np.zeros((pad, 3), np.float32)])
    infos = np.tile(np.eye(3, dtype=np.float32) * 50, (Ep, 1, 1))
    mask = np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])
    free = np.arange(M) > 0
    poses = gt + np.random.default_rng(1).normal(0, 0.05, gt.shape).astype(
        np.float32)
    poses[0] = gt[0]
    return M, (poses, eip, ejp, meansp, infos, mask, np.float32(1e-3), free)


@functools.lru_cache(maxsize=None)
def schur_case():
    """tests/test_schur.py's 64-node ring, as ``schur_delta`` takes it."""
    poses, ei, ej, means, infos, mask, free = schur_ring(64)
    return (poses, ei.astype(np.int64), ej.astype(np.int64), means, infos,
            mask, np.float32(1e-3), free)


@functools.lru_cache(maxsize=None)
def ring_search_case():
    rng = np.random.default_rng(4)
    return (rng.uniform(-10, 10, (16, 2)).astype(np.float32),
            rng.uniform(-10, 10, (64, 2)).astype(np.float32))


GRID = GridConfig(resolution=0.1, size_x=128, size_y=128, origin_x=-6.4,
                  origin_y=-6.4)


@functools.lru_cache(maxsize=None)
def logodds_case():
    rng = np.random.default_rng(2)
    n = 90
    angles = np.linspace(-np.pi, np.pi, n, endpoint=False)
    ranges = rng.uniform(1.0, 5.5, n)
    origin = np.asarray([0.3, -0.2], np.float32)
    endpoints = (origin + np.stack([ranges * np.cos(angles),
                                    ranges * np.sin(angles)], -1)).astype(
        np.float32)
    return origin, endpoints, np.ones(n, bool)


@functools.lru_cache(maxsize=None)
def hector_case():
    rng = np.random.default_rng(3)
    prob = rng.uniform(0, 1, (128, 128)).astype(np.float32)
    n = 120
    pts = (rng.uniform(-4, 4, (n, 2)) / GRID.resolution).astype(np.float32)
    return prob, np.asarray([64.0, 64.0, 0.1], np.float32), pts, np.ones(
        n, bool)


def training_case():
    cfg, args, _store, gt = matcher_case()
    rng = np.random.default_rng(9)
    poses = (gt + rng.normal(0, 0.03, gt.shape)).astype(np.float32)
    poses[0] = gt[0]
    return cfg, (*args, poses, np.float32(1e-3))


def _cases(D: int):
    cfg, args, store, _gt = matcher_case()
    M, lm_args = lm_case()
    q, kf = ring_search_case()
    out = [("collectives", {})]
    if D == 1:
        return out
    out += [
        ("matcher", dict(cfg=port_config(cfg), sp=args[0], sv=args[1],
                         tp=args[2], tv=args[3], g=args[4],
                         store_idx=store)),
        ("lm_delta", dict(args=lm_args, M=M, cg_iters=60)),
        ("schur_delta", dict(args=schur_case())),
        ("ring_search", dict(queries=q, kfs=kf)),
        ("logodds", dict(gcfg=port_config(GRID),
                         locfg=port_config(LogOddsConfig()),
                         origin=logodds_case()[0],
                         endpoints=logodds_case()[1],
                         valid=logodds_case()[2], max_range=6.0)),
    ]
    prob, pose, pts, valid = hector_case()
    out += [("hector_step", dict(gcfg=port_config(GRID), prob=prob,
                                 pose=pose, pts=pts, valid=valid,
                                 n_iters=n)) for n in (1, 3)]
    if D == 4:
        tcfg, targs = training_case()
        out.append(("training_step", dict(cfg=port_config(tcfg),
                                          args=targs)))
    return out


@functools.lru_cache(maxsize=None)
def port_at(D: int) -> dict:
    """{job: [rank 0's result, rank 1's, ...]} of the port at D ranks."""
    cases = _cases(D)
    per_rank = ranks.run(D, cases)
    names = [c[0] + (f"_{c[1]['n_iters']}" if c[0] == "hector_step" else "")
             for c in cases]
    return {n: [per_rank[r][k] for r in range(D)]
            for k, n in enumerate(names)}


def _same_on_every_rank(results, key=None):
    vals = [r if key is None else r[key] for r in results]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0])
    return vals[0]


# --- the mesh and its collectives ---------------------------------------


@pytest.mark.parametrize("D", [1, 2, 4])
def test_collectives(D):
    res = port_at(D)["collectives"]
    x = [np.arange(6, dtype=np.float32).reshape(2, 3) + 10.0 * r
         for r in range(D)]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["psum"], sum(x))
        np.testing.assert_array_equal(out["ppermute"], x[(r - 1) % D])
        np.testing.assert_array_equal(out["ppermute_self"],
                                      x[0] if r == 0 else 0 * x[0])
        np.testing.assert_array_equal(out["gather"], np.concatenate(x))
        np.testing.assert_array_equal(out["shard"],
                                      np.arange(4 * r, 4 * r + 4))
        # under a process group even one rank makes every call
        assert out["counts"] == {"psum": 1, "ppermute": 2, "all_gather": 1}
        assert out["shape"] == {"data": D} == dict(jmake_mesh(D).shape)
        assert out["repr"] == out["global"] == f"Mesh(data={D}, rank {r}, cpu, gloo)"


def test_ranks_that_hang_are_killed_at_the_deadline():
    t0 = time.monotonic()
    job = ranks.Ranks(2, [("hang", {})], deadline=15.0)
    procs = job._procs
    with pytest.raises(AssertionError, match="passed the 15 s deadline"):
        job.result()
    assert time.monotonic() - t0 < 45.0
    assert all(p.poll() is not None for p in procs)


def test_mesh_without_ranks():
    """Without a process group: one rank, identity collectives with no
    call; more than one rank raises and says to start them."""
    m = pm.make_mesh(device="cpu")
    assert (m.size, m.rank, m.group, m.shape) == (1, 0, None, {"data": 1})
    pm.reset_collectives()
    x = torch.arange(4.0)
    assert pm.psum(x, m) is x and pm.all_gather_rows(x, m) is x
    assert torch.equal(pm.ppermute(x, m, [(0, 0)]), x)
    assert sum(pm.COLLECTIVES.values()) == 0
    with pytest.raises(ValueError, match="start n ranks"):
        pm.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="tile"):
        pm.block(torch.arange(3), dataclasses.replace(m, size=2))


# --- sharded matchers ----------------------------------------------------


def _jax_matchers(D):
    from tpu_slam.parallel.distributed_step import (
        make_batched_matcher, make_indexed_matcher,
        make_packed_indexed_matcher,
    )

    cfg, args, (pts, valid, si, ti), _gt = matcher_case()
    mesh = jmake_mesh(D)
    sharded = make_batched_matcher(cfg, mesh)(
        *(shard_batch(mesh, jnp.asarray(a)) for a in args))
    sh = [shard_batch(mesh, jnp.asarray(a, jnp.int32)) for a in (si, ti)]
    g = shard_batch(mesh, jnp.asarray(args[4]))
    packed = make_packed_indexed_matcher(cfg, mesh)(
        replicated(mesh, jnp.asarray(pts)),
        replicated(mesh, jnp.asarray(valid)),
        replicated(mesh, jnp.zeros((1, 2), jnp.float32)), *sh, g)
    ind = make_indexed_matcher(cfg, mesh)(
        replicated(mesh, jnp.asarray(pts)),
        replicated(mesh, jnp.asarray(valid)), *sh, g)
    return (np.asarray(sharded.pose), np.asarray(packed),
            np.asarray(ind.pose))


def test_sharded_matchers_match_jax_and_one_device():
    res = port_at(2)["matcher"]
    out = {k: _same_on_every_rank(res, k) for k in res[0]}
    j_pose, j_packed, j_ind = _jax_matchers(2)
    np.testing.assert_allclose(out["pose"], j_pose, atol=1e-5)
    np.testing.assert_allclose(out["packed"][:, :3], j_packed[:, :3],
                               atol=1e-5)
    np.testing.assert_allclose(out["indexed"], j_ind, atol=1e-5)
    # the port on one device: the same pairs, the same kernel path
    cfg, args, (pts, valid, si, ti), _gt = matcher_case()
    pcfg = port_config(cfg)
    t = torch.as_tensor
    one = tds.make_batched_matcher(pcfg)(*(t(a) for a in args))
    np.testing.assert_array_equal(out["pose"], one.pose.numpy())
    np.testing.assert_array_equal(out["inliers"], one.num_inliers.numpy())
    np.testing.assert_array_equal(out["cov"], one.covariance.numpy())
    packed1 = tds.make_packed_indexed_matcher(pcfg)(
        t(pts), t(valid), torch.zeros(1, 2), t(si), t(ti), t(args[4]))
    np.testing.assert_array_equal(out["packed"], packed1.numpy())
    np.testing.assert_array_equal(out["indexed"], one.pose.numpy())


def test_sharded_matcher_batch_must_tile():
    cfg, args, _store, _gt = matcher_case()
    m = dataclasses.replace(pm.make_mesh(device="cpu"), size=3)
    with pytest.raises(ValueError, match="tile"):
        tds.make_batched_matcher(port_config(cfg), m)(
            *(torch.as_tensor(a) for a in args))


# --- distributed LM and CG deltas ----------------------------------------


def test_distributed_deltas_match_jax_and_one_device():
    from tpu_slam.solver.distributed import (
        make_distributed_cg_delta, make_distributed_lm_delta,
    )

    res = port_at(2)["lm_delta"]
    dense = _same_on_every_rank(res, "dense")
    cg = _same_on_every_rank(res, "cg")
    M, a = lm_case()
    mesh = jmake_mesh(2)
    jargs = (replicated(mesh, jnp.asarray(a[0])),
             *(shard_batch(mesh, jnp.asarray(x if x.dtype != np.int64
                                             else x.astype(np.int32)))
               for x in a[1:6]),
             jnp.float32(a[6]), replicated(mesh, jnp.asarray(a[7])))
    j_dense = np.asarray(make_distributed_lm_delta(mesh, M)(*jargs))
    j_cg = np.asarray(make_distributed_cg_delta(mesh, M, cg_iters=60)(*jargs))
    np.testing.assert_allclose(dense, j_dense, atol=2e-4)
    np.testing.assert_allclose(cg, j_cg, atol=5e-3)
    # the same deltas on one rank (no process group)
    one = pm.make_mesh(device="cpu")
    t = [torch.as_tensor(x) for x in a]
    t[6] = float(a[6])
    np.testing.assert_allclose(
        dense, tsd.make_distributed_lm_delta(one, M)(*t).numpy(), atol=2e-4)
    np.testing.assert_allclose(
        cg, tsd.make_distributed_cg_delta(one, M, 60)(*t).numpy(), atol=5e-3)
    np.testing.assert_allclose(cg, dense, atol=5e-3)


@pytest.mark.parametrize("D", [2, 4])
def test_distributed_schur_delta_matches_single(D):
    """make_distributed_schur_delta at S = D against schur_delta on one
    device at the same partition, within tests/test_schur.py's 1e-4, and
    against the reference's single-program step; every rank alike."""
    from tpu_slam.solver.schur import build_partition as jbuild
    from tpu_slam.solver.schur import schur_delta as jschur
    from tpu_slam_torch.solver.schur import build_partition, schur_delta

    dist = _same_on_every_rank(port_at(D)["schur_delta"])
    a = schur_case()
    M = len(a[0])
    t = [torch.as_tensor(x) for x in a]
    t[6] = float(a[6])
    single = schur_delta(build_partition(a[1], a[2], a[5], M, D), *t).numpy()
    np.testing.assert_allclose(dist, single, rtol=0, atol=1e-4)
    jpart = jbuild(a[1], a[2], a[5], M, D)
    ref = np.asarray(jax.jit(lambda *x: jschur(jpart, *x))(
        *(jnp.asarray(x) for x in a)))
    np.testing.assert_allclose(dist, ref, rtol=0, atol=1e-4)


# --- ring loop search ----------------------------------------------------


def test_ring_loop_search_matches_jax_and_direct():
    from tpu_slam.parallel.loop_search import make_ring_loop_search

    q, kf = ring_search_case()
    direct = ((q[:, None, :] - kf[None, :, :]) ** 2).sum(-1)
    for D in (2, 4):
        d2 = _same_on_every_rank(port_at(D)["ring_search"])
        np.testing.assert_allclose(d2, direct, rtol=1e-4, atol=1e-4)
        mesh = jmake_mesh(D)
        j = np.asarray(make_ring_loop_search(mesh)(
            shard_batch(mesh, jnp.asarray(q)),
            shard_batch(mesh, jnp.asarray(kf))))
        np.testing.assert_allclose(d2, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("exclude, want", [
    (None, [[3, 4, 5, 6, 7, 8]]),
    ({5}, []),  # an excluded id breaks the run
    ({12}, [[3, 4, 5, 6, 7, 8]]),
])
def test_loop_candidates(exclude, want):
    from tpu_slam.parallel.loop_search import loop_candidates as jloop

    row = np.full(20, 100.0)
    row[3:9] = 1.0  # a run of 6
    row[12:15] = 1.0  # a run of 3, too short
    got = loop_candidates(row, max_distance=2.0, min_chain=5,
                          exclude=exclude)
    assert got == want == jloop(row, 2.0, 5, exclude)


# --- striped maps --------------------------------------------------------


def test_sharded_logodds_update_matches_jax_and_unsharded():
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_slam.ops import gridmap as gm
    from tpu_slam.parallel.sharded_map import make_sharded_logodds_update
    from tpu_slam_torch.ops import gridmap as tgm

    origin, endpoints, valid = logodds_case()
    lo = LogOddsConfig()
    res = port_at(2)["logodds"]
    grid = _same_on_every_rank(res, "grid")
    # each rank's stripe is its rows of the whole grid
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["stripe"], grid[64 * r:64 * (r + 1)])
    mesh = jmake_mesh(2)
    j = make_sharded_logodds_update(mesh, GRID, lo, max_range=6.0)(
        jax.device_put(jnp.zeros((128, 128), jnp.float32),
                       NamedSharding(mesh, P("data"))),
        jnp.asarray(origin), jnp.asarray(endpoints), jnp.asarray(valid))
    np.testing.assert_allclose(grid, np.asarray(j), atol=1e-6)
    want = gm.logodds_update_scan(
        jnp.zeros((128 * 128,), jnp.float32), GRID, lo, jnp.asarray(origin),
        jnp.asarray(endpoints), jnp.asarray(valid), max_range=6.0)
    np.testing.assert_allclose(grid.reshape(-1), np.asarray(want), atol=1e-6)
    one = tgm.logodds_update_scan(
        torch.zeros(128 * 128), port_config(GRID), port_config(lo),
        torch.as_tensor(origin), torch.as_tensor(endpoints),
        torch.as_tensor(valid), max_range=6.0)
    np.testing.assert_array_equal(grid.reshape(-1), one.numpy())


@pytest.mark.parametrize("n_iters", [1, 3])
def test_sharded_hector_step_matches_jax_and_unsharded(n_iters):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpu_slam.ops.hector import gn_step
    from tpu_slam.parallel.sharded_map import make_sharded_hector_step
    from tpu_slam_torch.ops import hector as thec

    prob, pose, pts, valid = hector_case()
    res = port_at(2)[f"hector_step_{n_iters}"]
    got_pose = _same_on_every_rank(res, "pose")
    got_H = _same_on_every_rank(res, "H")
    mesh = jmake_mesh(2)
    j_pose, j_H = make_sharded_hector_step(mesh, GRID, n_iters=n_iters)(
        jax.device_put(jnp.asarray(prob), NamedSharding(mesh, P("data"))),
        jnp.asarray(pose), jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_allclose(got_pose, np.asarray(j_pose), atol=1e-4)
    np.testing.assert_allclose(got_H, np.asarray(j_H), rtol=1e-4, atol=1e-3)
    # the unsharded GN steps, both packages
    p, tp = jnp.asarray(pose), torch.as_tensor(pose)
    for _ in range(n_iters):
        p, H = gn_step(jnp.asarray(prob).reshape(-1), 128, 128, p,
                       jnp.asarray(pts), jnp.asarray(valid), 0.2)
        tp, tH = thec.gn_step(torch.as_tensor(prob).reshape(-1), 128, 128,
                              tp, torch.as_tensor(pts),
                              torch.as_tensor(valid), 0.2)
    np.testing.assert_allclose(got_pose, np.asarray(p), atol=1e-4)
    np.testing.assert_allclose(got_pose, tp.numpy(), atol=1e-4)
    np.testing.assert_allclose(got_H, tH.numpy(), rtol=1e-4, atol=1e-3)


# --- the distributed SLAM step -------------------------------------------


def test_training_step_matches_jax_at_four_ranks():
    from tpu_slam.parallel.distributed_step import make_sharded_training_step

    res = port_at(4)["training_step"]
    poses = _same_on_every_rank(res, "poses")
    errs = _same_on_every_rank(res, "errors")
    cfg, a = training_case()
    mesh = jmake_mesh(4)
    j_poses, j_errs = make_sharded_training_step(mesh, cfg)(
        *(jnp.asarray(x) for x in a[:5]), jnp.asarray(a[5]),
        jnp.float32(a[6]))
    np.testing.assert_allclose(errs, np.asarray(j_errs), atol=1e-5)
    np.testing.assert_allclose(poses, np.asarray(j_poses), atol=1e-4)
    # the step moves the poses toward the matched chain
    assert np.all(np.isfinite(poses)) and not np.array_equal(poses, a[5])
