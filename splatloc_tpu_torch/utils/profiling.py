"""Tracing, timing and metrics.

Port of ``splatloc_tpu.utils.profiling``:

- ``trace``: a torch.profiler window written as a Chrome/Perfetto trace
- ``Timer``: wall-clock timer that waits for the device's results
- ``count_syncs``: the host syncs a function makes on the card
- ``log_collectives``: the torch.distributed collectives a block calls,
  with their sizes
- ``throughput_mpix_s``: megapixels rendered per second
- ``MetricsLogger``: structured jsonl metrics stream, the JAX package's
  records
"""
from __future__ import annotations

import contextlib
import json
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Capture a trace of the block into ``logdir`` (a
    ``<worker>.<time>.pt.trace.json`` that Perfetto and chrome://tracing
    open). On the card only the device's activity is recorded: the host
    events of a long block (a localization query issues ~250k ops) take
    the profiler minutes to sort; on the CPU, the host's."""
    from torch.profiler import ProfilerActivity, profile, \
        tensorboard_trace_handler
    cuda = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)):
        yield
        if cuda:
            torch.cuda.synchronize(device)


def _cuda_devices(out) -> set:
    """The CUDA devices of the tensors in a nest of tuples, lists and
    dicts."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in out))
    return set()


class Timer:
    """Wall-clock timer that waits for device results."""

    def __init__(self, name: str = ""):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total += time.perf_counter() - self._t0
        self.count += 1
        return False

    def timed(self, fn, *args, **kw):
        """Run fn, wait for the CUDA devices of its output tensors, record
        the time."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        for dev in _cuda_devices(out):
            torch.cuda.synchronize(dev)
        self.total += time.perf_counter() - t0
        self.count += 1
        return out

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total / max(self.count, 1)

    def __repr__(self):
        return f"Timer({self.name}: {self.mean_ms:.2f} ms x {self.count})"


# in the warning torch.cuda.set_sync_debug_mode("warn") gives at each
# sync; the first switch of the mode in a process warns once as well, so
# count_syncs switches it on and off once before it counts
SYNC_WARNING = "synchroniz"


def count_syncs(fn):
    """(fn's result, the host syncs it made on the card): the warnings of
    torch.cuda.set_sync_debug_mode("warn") while fn runs."""
    import warnings
    with warnings.catch_warnings(record=True):
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum(SYNC_WARNING in str(x.message) for x in w)


@contextlib.contextmanager
def log_collectives():
    """Record every ``torch.distributed.all_reduce`` and ``all_gather``
    called inside the block: yields a list that fills with one dict per
    call (op, shape, dtype, bytes of this rank's input tensor)."""
    import torch.distributed as dist
    calls = []
    saved = dist.all_reduce, dist.all_gather

    def record(op, t):
        calls.append({"op": op, "shape": list(t.shape),
                      "dtype": str(t.dtype).replace("torch.", ""),
                      "bytes": t.numel() * t.element_size()})

    def all_reduce(tensor, *a, **kw):
        record("all_reduce", tensor)
        return saved[0](tensor, *a, **kw)

    def all_gather(tensor_list, tensor, *a, **kw):
        record("all_gather", tensor)
        return saved[1](tensor_list, tensor, *a, **kw)

    dist.all_reduce, dist.all_gather = all_reduce, all_gather
    try:
        yield calls
    finally:
        dist.all_reduce, dist.all_gather = saved


def throughput_mpix_s(width: int, height: int, iters: int,
                      seconds: float) -> float:
    return width * height * iters / seconds / 1e6


class MetricsLogger:
    """Append-only jsonl metrics (step, name, value, wall time)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._t0 = time.time()

    def log(self, step: int, **metrics):
        rec = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            rec[k] = float(v) if hasattr(v, "__float__") else v
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]
