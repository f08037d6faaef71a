"""Multi-process scaffolding: which process writes host-side artifacts.

Port of ``splatloc_tpu.dist.multihost``'s ``is_primary`` and
``primary_only``: checkpoints, eval reports and metrics streams are written
by rank 0 only. The port has no multi-GPU path yet (ROADMAP queue A), so
outside an initialized ``torch.distributed`` group every process is the
primary.
"""
from __future__ import annotations

import functools

import torch.distributed as dist


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
