"""Faults planted under the timed path, each a context manager that
patches the program while it is open. ``calibrate.py --faults`` reads
the check numbers they give on the card; the CPU tests see each read
``correct`` false.

  * ``unchanged_state``: the solve returns the poses it was given;
  * ``half_batch``: the chain's PL-ICP batch matches its first half, the
    second half keeps the odometry's guesses;
  * ``altered_answer``: one pose of the answer moved by 5 cm;
  * ``no_loops``: the offline driver finds no loop candidate;
  * ``half_candidates``: the offline driver tries every other loop
    candidate of each round and never the rest.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged_state():
    from tpu_slam_torch.solver import pose_graph

    return patched(pose_graph.PoseGraphSolver, "compute",
                   lambda self, max_iterations=None: None)


def half_batch():
    from tpu_slam_torch.models import offline

    make = offline.make_chain_matcher

    def half(cfg):
        f = make(cfg)

        def g(store, valid, dirs, si, ti, guesses, pose0):
            out = f(store, valid, dirs, si, ti, guesses, pose0).clone()
            B = guesses.shape[0]
            out[B // 2:B, :3] = guesses[B // 2:]
            return out
        return g

    return patched(offline, "make_chain_matcher", half)


def altered_answer():
    from tpu_slam_torch.solver import pose_graph

    get = pose_graph.PoseGraphSolver.get_poses

    def moved(self):
        p = get(self).copy()
        p[len(p) // 2, 0] += 0.05
        return p

    return patched(pose_graph.PoseGraphSolver, "get_poses", moved)


def no_loops():
    from tpu_slam_torch.models import offline

    return patched(offline, "_loop_candidates",
                   lambda poses, ocfg, tried: [])


def half_candidates():
    from tpu_slam_torch.models import offline

    find = offline._loop_candidates

    def half(poses, ocfg, tried):
        cands = find(poses, ocfg, tried)
        tried.update(cands[1::2])  # left out for good, not found again
        return cands[::2]

    return patched(offline, "_loop_candidates", half)


FAULTS = {f.__name__: f for f in (unchanged_state, half_batch, altered_answer,
                                  no_loops, half_candidates)}
