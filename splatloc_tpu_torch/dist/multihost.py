"""Multi-process scaffolding: joining the job's processes, and which one
writes host-side artifacts.

Port of ``splatloc_tpu.dist.multihost``'s ``initialize``, ``is_primary``
and ``primary_only``. ``initialize`` joins the processes into one
``torch.distributed`` group under the JAX package's environment contract:

  SPLATLOC_COORDINATOR   host:port of process 0 (absent => single-process)
  SPLATLOC_NUM_PROCESSES total process count
  SPLATLOC_PROCESS_ID    this process's id in [0, NUM_PROCESSES)

Checkpoints, eval reports and metrics streams are written by rank 0 only;
outside an initialized group every process is the primary. The global
device mesh (``global_mesh``) comes with the multi-GPU path (ROADMAP A).
"""
from __future__ import annotations

import functools
import os

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
