"""The one traffic generator: a traffic file's parameters and a seed in,
the pool of requests a run cycles through out. Host numpy only.

Every seed gives the same sizes: a mission's scan count and beams, a
graph's nodes and edges are fixed by the file; the seed draws the sensor
noise, the odometry drift and the measurement noise, and the order in
which the window visits the pool.

Recipes (``kind``):
  * ``corridor_mission``: a square corridor loop world (``arm``,
    ``width``), the robot ``laps`` times round its centre line without a
    break (one pose follows the last as the robot drives) at
    ``speed`` m/s, one scan every ``scan_period`` s of ``beams`` beams
    to ``range_max``, range noise ``noise_std``; odometry = the true poses
    plus a random walk of per-scan std ``odom_drift_std`` (x, y, θ).
  * ``ring_graph``: ``nodes`` poses on a circle of ``radius``, an edge
    between neighbours and one across the circle every ``closure_every``
    nodes, information ``info_diag``; each measurement the true relative
    pose plus N(0, ``edge_noise_std``) where the file gives it (exact
    where it does not); the initial guess the truth plus a random walk of
    std ``drift_std``.
  * ``loop_chain_graph``: ``nodes`` poses over ``loops`` turns of a circle
    of ``radius``; odometry edges with N(0, ``odom_noise_std``) added,
    closures between turn k and k + 1 every ``closure_every`` nodes
    (exact), information ``info_diag``; the initial guess is the noisy
    odometry integrated from the first true pose.

The world, trajectory and ray caster are frozen copies of the simulator
the repository's recipes use (``corridor_loop_world``, ``loop_trajectory``,
``waypoint_trajectory``, ``raycast``, the range part of
``simulate_sequence``), so that a later change to the program cannot move
the yardstick.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from slam_bench import geometry as g


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator per (seed, stream...)."""
    return np.random.default_rng([int(seed) % (1 << 63), *stream])


# --- the simulator (frozen copy) ----------------------------------------------

def box_segments(xmin, ymin, xmax, ymax) -> np.ndarray:
    return np.array([[xmin, ymin, xmax, ymin], [xmax, ymin, xmax, ymax],
                     [xmax, ymax, xmin, ymax], [xmin, ymax, xmin, ymin]],
                    np.float64)


def corridor_loop_world(arm: float, width: float) -> np.ndarray:
    """(S, 4) wall segments of a square corridor loop with four pillars."""
    h = arm / 2
    wi = h - width
    segs = [box_segments(-h, -h, h, h), box_segments(-wi, -wi, wi, wi)]
    for cx, cy in [(0, h - 0.4), (h - 0.4, 0), (0, -(h - 0.4)),
                   (-(h - 0.4), 0.8)]:
        segs.append(box_segments(cx - 0.15, cy - 0.15, cx + 0.15, cy + 0.15))
    return np.concatenate(segs)


def waypoint_trajectory(waypoints, speed: float, turn_rate: float = 0.8,
                        dt: float = 0.1) -> np.ndarray:
    """Drive through waypoints with a unicycle model → poses (n, 3)."""
    poses = []
    x, y = waypoints[0]
    th = math.atan2(waypoints[1][1] - y, waypoints[1][0] - x)
    for wx, wy in waypoints[1:]:
        for _ in range(10000):
            dx, dy = wx - x, wy - y
            if math.hypot(dx, dy) < 0.15:
                break
            err = math.atan2(math.sin(math.atan2(dy, dx) - th),
                             math.cos(math.atan2(dy, dx) - th))
            w = np.clip(err / dt, -turn_rate, turn_rate)
            v = speed * max(0.2, math.cos(err))
            th = th + w * dt
            x += v * math.cos(th) * dt
            y += v * math.sin(th) * dt
            poses.append((x, y, math.atan2(math.sin(th), math.cos(th))))
    return np.array(poses, dtype=np.float64)


def loop_trajectory(arm: float, width: float, speed: float, dt: float,
                    laps: int = 1) -> np.ndarray:
    """``laps`` closed laps of the corridor's centre line, driven without a
    break, then on past the start."""
    m = (arm / 2 + (arm / 2 - width)) / 2
    lap = [[m, -m], [m, m], [-m, m], [-m, -m]]
    wps = np.array([[-m, -m]] + lap * int(laps) + [[0.0, -m]])
    return waypoint_trajectory(wps, speed=speed, dt=dt)


def raycast(segments, origins, angles, range_max: float) -> np.ndarray:
    """Exact ray–segment intersection: (B,) ranges, +inf past range_max."""
    p = segments[:, 0:2][None]
    pq = (segments[:, 2:4] - segments[:, 0:2])[None]
    o = origins[:, None, :]
    d = np.stack([np.cos(angles), np.sin(angles)], -1)[:, None, :]
    po = p - o
    denom = d[..., 0] * pq[..., 1] - d[..., 1] * pq[..., 0]
    denom = np.where(np.abs(denom) < 1e-12, np.nan, denom)
    t = (po[..., 0] * pq[..., 1] - po[..., 1] * pq[..., 0]) / denom
    u = (po[..., 0] * d[..., 1] - po[..., 1] * d[..., 0]) / denom
    t = np.where((t > 1e-9) & (u >= 0.0) & (u <= 1.0), t, np.inf)
    r = np.nanmin(np.where(np.isnan(t), np.inf, t), axis=1)
    return np.where(r <= range_max, r, np.inf)


# --- requests -----------------------------------------------------------------

@dataclasses.dataclass
class Mission:
    ranges: np.ndarray  # (T, N) float32, inf = no return
    stamps: np.ndarray  # (T,) float32
    odom: np.ndarray  # (T, 3) drifting odometry
    truth: np.ndarray  # (T, 3) true sensor poses
    angle_min: float
    angle_increment: float


@dataclasses.dataclass
class Graph:
    init: np.ndarray  # (M, 3) initial guess; node 0 is the gauge
    ei: np.ndarray  # (E,) int64
    ej: np.ndarray
    means: np.ndarray  # (E, 3)
    infos: np.ndarray  # (E, 3, 3)


def corridor_mission(t: dict, rng: np.random.Generator) -> Mission:
    truth = loop_trajectory(t["arm"], t["width"], t["speed"], t["scan_period"],
                            t["laps"])
    world = corridor_loop_world(t["arm"], t["width"])
    n = int(t["beams"])
    a0 = -math.pi
    inc = 2.0 * math.pi / n
    beam = a0 + inc * np.arange(n)
    ranges = np.empty((len(truth), n))
    for k, p in enumerate(truth):
        ranges[k] = raycast(world, np.broadcast_to(p[:2], (n, 2)),
                            p[2] + beam, t["range_max"])
    finite = np.isfinite(ranges)
    ranges[finite] += rng.normal(0.0, t["noise_std"], finite.sum())
    drift = np.cumsum(rng.normal(0.0, t["odom_drift_std"], (len(truth), 3)), 0)
    stamps = (np.arange(len(truth)) * t["scan_period"]).astype(np.float32)
    return Mission(ranges.astype(np.float32), stamps, truth + drift, truth,
                   a0, inc)


def _graph(init, pairs, means, info_diag) -> Graph:
    ei, ej = np.asarray(pairs, np.int64).T
    info = np.broadcast_to(np.diag(np.asarray(info_diag, np.float64)),
                           (len(ei), 3, 3)).copy()
    return Graph(np.asarray(init, np.float64), ei, ej,
                 np.asarray(means, np.float64), info)


def ring_graph(t: dict, rng: np.random.Generator) -> Graph:
    M, r = int(t["nodes"]), float(t["radius"])
    th = np.linspace(0, 2 * np.pi, M, endpoint=False)
    truth = np.stack([r * np.cos(th), r * np.sin(th), th + np.pi / 2], -1)
    init = truth + np.cumsum(rng.normal(0, t["drift_std"], (M, 3)), 0)
    pairs = [(i, (i + 1) % M) for i in range(M)]
    pairs += [(i, (i + M // 2) % M) for i in range(0, M, int(t["closure_every"]))]
    ei, ej = np.array(pairs).T
    means = g.relative(truth[ei], truth[ej])
    if "edge_noise_std" in t:
        means = means + rng.normal(0, t["edge_noise_std"], means.shape)
    return _graph(init, pairs, means, t["info_diag"])


def loop_chain_graph(t: dict, rng: np.random.Generator) -> Graph:
    n, r = int(t["nodes"]), float(t["radius"])
    th = np.linspace(0, 2 * np.pi * int(t["loops"]), n)
    truth = np.stack([r * np.cos(th), r * np.sin(th), th + np.pi / 2], -1)
    truth[:, 2] = g.wrap(truth[:, 2])
    odo = g.relative(truth[:-1], truth[1:]) + rng.normal(
        0, t["odom_noise_std"], (n - 1, 3))
    period = n // int(t["loops"])
    pairs = [(i, i + 1) for i in range(n - 1)]
    loop = list(range(0, n - period, int(t["closure_every"])))
    pairs += [(i, i + period) for i in loop]
    means = np.concatenate([odo, g.relative(truth[loop], truth[[i + period
                                                                 for i in loop]])])
    return _graph(g.integrate(truth[0], odo), pairs, means, t["info_diag"])


RECIPES = {"corridor_mission": corridor_mission, "ring_graph": ring_graph,
           "loop_chain_graph": loop_chain_graph}


def make_pool(traffic: dict, seed: int) -> list:
    """The ``traffic["pool"]`` requests of this seed, each from a stream of
    its own."""
    recipe = RECIPES[traffic["kind"]]
    return [recipe(traffic, rng_for(seed, 1, k))
            for k in range(int(traffic["pool"]))]


def visit_order(traffic: dict, seed: int):
    """The pool indices in the order the window visits them, without end:
    each pass over the pool a fresh permutation."""
    P = int(traffic["pool"])
    rng = rng_for(seed, 2)
    while True:
        yield from (int(k) for k in rng.permutation(P))
