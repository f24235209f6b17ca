"""Multi-process runtime entry — port of ``tpu_slam/parallel/multihost.py``.

Every process runs the same program: ``initialize()`` joins it to the
process group, and the global mesh spans all ranks. The sharded callables
of this package run unchanged on any such mesh. Nothing on a machine
tells a program of its cluster: the coordinator's address, the number of
processes and this process's id are the caller's to give.
"""

from __future__ import annotations

from datetime import timedelta

import torch.distributed as dist

from tpu_slam_torch._dispatch import DEFAULT_DEVICE
from tpu_slam_torch.parallel.mesh import Mesh, make_mesh


# how long a rank waits for the others to join, and in any collective
INIT_TIMEOUT = timedelta(seconds=60)


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "nccl") -> None:
    """Join the process group at ``tcp://coordinator`` ("host:port") as
    rank ``process_id`` of ``num_processes``; nothing for one process.
    ``backend`` is NCCL for ranks a card each, gloo for ranks on the CPU
    or sharing a card."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id, timeout=INIT_TIMEOUT)


def global_mesh(axis: str = "data", device=DEFAULT_DEVICE,
                backend: str | None = None) -> Mesh:
    """One 1-D mesh over every rank of every process."""
    return make_mesh(None, axis, device, backend)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
