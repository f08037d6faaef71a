"""Multi-process scaffolding: joining the job's processes, and which one
writes host-side artifacts.

Port of ``splatloc_tpu.dist.multihost``'s ``initialize``, ``is_primary``
and ``primary_only``. ``initialize`` joins the processes into one
``torch.distributed`` group under the JAX package's environment contract:

  SPLATLOC_COORDINATOR   host:port of process 0 (absent => single-process)
  SPLATLOC_NUM_PROCESSES total process count
  SPLATLOC_PROCESS_ID    this process's id in [0, NUM_PROCESSES)

Checkpoints, eval reports and metrics streams are written by rank 0 only;
outside an initialized group every process is the primary.

``global_mesh`` arranges the job's ranks into a ``Mesh``: the counterpart
of a ``jax.sharding.Mesh`` for explicit ``torch.distributed`` code. XLA's
partitioner inserted the collectives of a sharded JAX program; here the
sharded functions call them on the mesh's per-axis groups
(``Mesh.all_reduce``, ``Mesh.all_gather``), in whatever backend the
default group was made with.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids: list[int] | None = None) -> bool:
    """Join the job's processes through torch.distributed: nccl where CUDA
    is available (on the first of ``local_device_ids``, else this process's
    id modulo the local device count), gloo on the CPU. Arguments default
    to the SPLATLOC_* environment contract; returns True if the
    multi-process group was initialized, False for the (default)
    single-process path."""
    coordinator = coordinator or os.environ.get("SPLATLOC_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ["SPLATLOC_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["SPLATLOC_PROCESS_ID"])
    if num_processes <= 1:
        return False
    backend = "gloo"
    if torch.cuda.is_available():
        backend = "nccl"
        torch.cuda.set_device(local_device_ids[0] if local_device_ids
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return True


def is_primary() -> bool:
    """True on the process that owns host-side artifact writes: always
    when torch.distributed is not initialized, rank 0 otherwise."""
    if not (dist.is_available() and dist.is_initialized()):
        return True
    return dist.get_rank() == 0


def primary_only(fn):
    """Decorator: run fn on the primary process only; the others return
    None. For checkpoint/report writers; collectives must not be guarded
    with this (every process takes part in those)."""
    @functools.wraps(fn)
    def wrapped(*a, **kw):
        if is_primary():
            return fn(*a, **kw)
        return None
    return wrapped


def _world() -> tuple[int, int]:
    """(this process's rank, the world size); (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks arranged on named axes, as ``jax.sharding.Mesh`` arranges
    devices. ``ranks`` has one dimension per axis; ``groups`` maps an axis to
    the ``torch.distributed`` group of this rank's slice along it (None for
    an axis of size 1, which needs no communication). ``rank`` is this
    process's global rank."""
    ranks: np.ndarray
    axis_names: tuple[str, ...]
    groups: dict
    rank: int

    @property
    def shape(self) -> dict:
        """axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.ranks.shape))

    def index(self, axis: str) -> int:
        """This rank's position along ``axis`` (``jax.lax.axis_index``)."""
        where = np.argwhere(self.ranks == self.rank)
        if len(where) == 0:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return int(where[0][self.axis_names.index(axis)])

    def all_reduce(self, x: torch.Tensor, axis: str,
                   op: str = "sum") -> torch.Tensor:
        """``x`` reduced over ``axis`` ("sum" or "max"), into a new tensor
        (``x`` itself where the axis has size 1). Every rank of the slice
        gets the same bits."""
        group = self.groups[axis]
        if group is None:
            return x
        out = x.contiguous().clone()
        dist.all_reduce(out, {"sum": dist.ReduceOp.SUM,
                              "max": dist.ReduceOp.MAX}[op], group=group)
        return out

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The slices' ``x`` concatenated along dim 0 in axis order."""
        group = self.groups[axis]
        if group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts)


def mesh_of(axis_sizes: dict, ranks=None) -> Mesh:
    """A Mesh of ``axis_sizes`` (name -> size, in order) over the first
    prod(sizes) of ``ranks`` (default: every rank of the default group, in
    rank order). Every process of the default group must call it, in the
    same order as every other group it makes: ``new_group`` is collective.
    A mesh of one rank needs no process group."""
    me, world = _world()
    n = math.prod(axis_sizes.values())
    ranks = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(ranks) < n:
        raise ValueError(f"{len(ranks)} ranks for a mesh of {axis_sizes}")
    arr = np.asarray(ranks[:n], dtype=np.int64).reshape(
        tuple(axis_sizes.values()))
    groups = {}
    for i, name in enumerate(axis_sizes):
        groups[name] = None
        if arr.shape[i] == 1:
            continue
        for line in np.moveaxis(arr, i, -1).reshape(-1, arr.shape[i]):
            group = dist.new_group([int(r) for r in line])
            if me in line:
                groups[name] = group
    return Mesh(ranks=arr, axis_names=tuple(axis_sizes), groups=groups,
                rank=me)


def global_mesh(**axis_sizes) -> Mesh:
    """Mesh over all processes' ranks, e.g. global_mesh(data=2, gauss=4).
    Rank order is process-major, as ``jax.devices()`` orders devices, so a
    leading 'data' axis maps frames to processes."""
    return mesh_of(axis_sizes)
