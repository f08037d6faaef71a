"""Tracing, timing and metrics.

Port of ``splatloc_tpu.utils.profiling``:

- ``trace``: a torch.profiler window written as a Chrome/Perfetto trace
- ``span`` / ``count``: the program's own spans and counters at its layer
  boundaries, off unless ``enable()`` turned them on; ``drain()`` hands
  them over
- ``count_syncs``: the host syncs a function makes on the card
- ``log_collectives``: the torch.distributed collectives a block calls,
  with their sizes
- ``MetricsLogger``: structured jsonl metrics stream, the JAX package's
  records
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

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


# -- spans and counters ------------------------------------------------
#
# Off (the default), ``span`` is one test of the module flag ``_ON`` and
# returns the shared no-op context ``_OFF``, and ``count`` is one test: no
# clock read, no record_function, nothing kept. On, a span reads
# time.perf_counter_ns at its edges and also opens a
# torch.profiler.record_function of its name, so inside a torch.profiler
# window it is a ``user_annotation`` event on the profiler's own clock. A
# span never synchronizes the device: on the card its wall is the host's
# time to issue its work, plus any wait its own code makes.

SPAN_CAP = 1 << 17       # spans kept between two drain() calls


class Span(NamedTuple):
    """One closed span. ``attrs`` are its ids (``iteration=``,
    ``query=``), its parent's merged under its own, so every span of one
    request carries the request's id; ``parent`` is the enclosing span's
    ``id`` on the same thread (None at the top)."""
    name: str
    id: int
    parent: int | None
    attrs: dict
    t0_ns: int
    t1_ns: int
    thread: int


_OFF = contextlib.nullcontext()
_ON = False


class _Tracer:
    """What the spans and counters record between two drain() calls."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.spans: list = []
        self.counters: dict = {}
        self.dropped = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st


_TRACER = _Tracer()


class _OnSpan:
    __slots__ = ("name", "attrs", "id", "parent", "rf", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        st = _TRACER.stack()
        if st:
            top = st[-1]
            self.parent = top.id
            if top.attrs:
                self.attrs = {**top.attrs, **self.attrs}
        else:
            self.parent = None
        self.id = next(_TRACER.ids)
        st.append(self)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        _TRACER.stack().pop()
        rec = Span(self.name, self.id, self.parent, self.attrs, self.t0, t1,
                   threading.get_native_id())
        with _TRACER.lock:
            if len(_TRACER.spans) < SPAN_CAP:
                _TRACER.spans.append(rec)
            else:
                _TRACER.dropped += 1
        return False


def span(name: str, **attrs):
    """A context manager around one layer's work: a no-op while tracing is
    off, else a recorded ``Span`` (ids in ``attrs``)."""
    if not _ON:
        return _OFF
    return _OnSpan(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer the caller already holds: never a device
    value, whose read would sync) to the counter ``name``; a no-op while
    tracing is off."""
    if not _ON:
        return
    with _TRACER.lock:
        _TRACER.counters[name] = _TRACER.counters.get(name, 0) + n


def enable() -> None:
    """Turn spans and counters on, keeping at most ``SPAN_CAP`` spans until
    the next drain() (those past it are counted in ``spans_dropped``)."""
    global _ON
    _ON = True


def disable() -> None:
    """Turn spans and counters off; what they recorded stays until
    drain()."""
    global _ON
    _ON = False


def drain() -> dict:
    """{"spans": [Span] in the order they closed, "counters": {name: n},
    "spans_dropped": spans past the cap}, and clear them."""
    with _TRACER.lock:
        out = {"spans": _TRACER.spans, "counters": _TRACER.counters,
               "spans_dropped": _TRACER.dropped}
        _TRACER.spans, _TRACER.counters, _TRACER.dropped = [], {}, 0
    return out


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
