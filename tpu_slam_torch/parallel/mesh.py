"""The device mesh of the multi-device layer — port of
``tpu_slam/parallel/mesh.py``.

The reference runs this layer as one process over D devices under
``shard_map``. The port runs D processes, one rank each, joined by
``torch.distributed``. One 1-D axis (``data``) carries both forms of
parallelism the workload has: scan-pair batches sharded over the ranks
(no communication), and pose-graph edges sharded over them, with every
edge's normal-equation terms gathered (``solver/distributed``).

A ``Mesh`` is the process group, its size D and this process's rank, the
axis name and the rank's device. Collectives are plain functions over a
mesh. ``backend`` follows the device: NCCL on ``cuda``, gloo on ``cpu``.
Ranks that share one card must ask for gloo: NCCL refuses two ranks on
one device. Under gloo the collectives copy CUDA tensors to the host and
back (the repr says so); the compute stays on the card.

Every sharded callable of the layer takes the global tensors, the same on
every rank, slices its rank's block (``shard_batch``) and returns global
results: a replicated output is the all-reduced one, an output sharded
over the axis is gathered (``all_gather_rows``). Any branch a caller
takes must be computed from such replicated values, or the ranks part and
one of them waits forever in a collective.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpu_slam_torch._dispatch import DEFAULT_DEVICE

# the calls of each collective since the last ``reset_collectives()``
COLLECTIVES: dict[str, int] = {"psum": 0, "ppermute": 0, "all_gather": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True, eq=False)
class Mesh:
    """D ranks on one axis. ``group`` is None for a mesh of one rank
    without a process group; its collectives are then the identity and make
    no call."""

    group: object
    size: int
    rank: int
    axis: str
    device: torch.device
    backend: str  # "nccl", "gloo" or "none"

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis: self.size}

    @property
    def host_copies(self) -> bool:
        """True where collectives go through host copies (gloo, CUDA)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def __repr__(self) -> str:
        via = (", collectives copy CUDA tensors through the host"
               if self.host_copies else "")
        return (f"Mesh({self.axis}={self.size}, rank {self.rank}, "
                f"{self.device}, {self.backend}{via})")


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def default_backend(device) -> str:
    """The collectives' backend for ranks on ``device``: NCCL on ``cuda``,
    gloo on ``cpu``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=DEFAULT_DEVICE, backend: str | None = None) -> Mesh:
    """A mesh over the first ``n_devices`` ranks of the initialized process
    group (all of them by default), or a mesh of one rank where no group is
    initialized. Asking for more than one rank without a group raises: the
    ranks must be started first (``multihost.initialize``).

    ``device`` "cuda" puts each rank on ``cuda:{LOCAL_RANK}`` (the rank
    where ``LOCAL_RANK`` is not set); a device with an index is taken as
    it is. ``backend`` defaults to NCCL on ``cuda`` and gloo on ``cpu``.
    A process group of another backend than the mesh's gets a subgroup of
    the mesh's."""
    dev = torch.device(device)
    backend = backend or default_backend(dev)
    if not dist.is_initialized():
        n = 1 if n_devices is None else int(n_devices)
        if n > 1:
            raise ValueError(
                f"a mesh of {n} ranks needs {n} processes joined in a "
                "process group: start n ranks and call "
                "multihost.initialize (or torch.distributed."
                "init_process_group) in each first")
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", 0)
        return Mesh(None, 1, 0, axis, dev, "none")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a group of {world}")
    if n == world and dist.get_backend() == backend:
        group = dist.group.WORLD
    else:  # every rank of the world must take part in new_group
        group = dist.new_group(list(range(n)), backend=backend)
    if rank >= n:
        raise ValueError(f"rank {rank} is not among the mesh's first {n}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    if backend == "nccl":  # NCCL works on the current device
        torch.cuda.set_device(dev)
    return Mesh(group, n, rank, axis, dev, backend)


def _via_host(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return t.cpu() if mesh.host_copies else t


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``t`` over the ranks (all_reduce SUM), on every rank; a
    new tensor on ``t``'s device."""
    if mesh.group is None:
        return t
    buf = _via_host(t, mesh).clone().contiguous()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    out = buf.to(t.device)
    COLLECTIVES["psum"] += 1
    return out


def psum_packed(mesh: Mesh, *ts):
    """One psum of several tensors; returns them summed, in their shapes."""
    flat = psum(torch.cat([t.reshape(-1) for t in ts]), mesh)
    out, k = [], 0
    for t in ts:
        out.append(flat[k:k + t.numel()].view(t.shape))
        k += t.numel()
    return out


def _peer(mesh: Mesh, r: int) -> int:
    """The global rank of the mesh's rank ``r``."""
    return dist.get_global_rank(mesh.group, r)


def ppermute(t: torch.Tensor, mesh: Mesh, perm) -> torch.Tensor:
    """``jax.lax.ppermute``: rank ``dst`` receives the ``t`` of rank
    ``src`` for each (src, dst) of ``perm``; a rank that receives nothing
    gets zeros. A pair from a rank to itself is a local copy."""
    recv = torch.zeros_like(t)
    if mesh.group is None:
        for src, dst in perm:
            if src == dst == 0:
                recv = t.clone()
        return recv
    send_buf = _via_host(t, mesh).contiguous()
    recv_buf = _via_host(recv, mesh)
    ops, me = [], mesh.rank
    for src, dst in perm:
        if src == me and dst == me:
            recv_buf = send_buf.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send_buf, _peer(mesh, dst),
                                  mesh.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, recv_buf, _peer(mesh, src),
                                  mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    out = recv_buf.to(t.device)
    COLLECTIVES["ppermute"] += 1
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The blocks of every rank along dim 0, in rank order: the global
    form of an output sharded over the axis."""
    if mesh.group is None:
        return t
    buf = _via_host(t, mesh).contiguous()
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    out = torch.cat(parts, dim=0).to(t.device)
    COLLECTIVES["all_gather"] += 1
    return out


def block(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t``'s leading axis, which must tile D."""
    n = t.shape[0]
    if n % mesh.size:
        raise ValueError(f"a leading axis of {n} does not tile "
                         f"{mesh.axis}={mesh.size}: pad it")
    b = n // mesh.size
    return t[mesh.rank * b:(mesh.rank + 1) * b]


def _tree_map(fn, tree):
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def shard_batch(mesh: Mesh, tree):
    """This rank's block of the leading axis of every tensor of ``tree``,
    on the mesh's device."""
    return _tree_map(
        lambda x: block(torch.as_tensor(x, device=mesh.device), mesh), tree)


def replicated(mesh: Mesh, tree):
    """Every tensor of ``tree`` whole, on the mesh's device."""
    return _tree_map(lambda x: torch.as_tensor(x, device=mesh.device), tree)
