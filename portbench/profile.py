"""One traced window: torch.profiler over host and device, reduced to the
device's busy time, its idle gaps named by what the host was doing, device
operations named by the host operation that launched them, and kernel
time by kernel.

The trace is written to a temporary file (``TMPDIR``) and removed once
read.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import re
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"


def short_kernel(name: str) -> str:
    """``void (anonymous namespace)::fwd_pairwalk_kernel<4>(...)`` ->
    ``fwd_pairwalk_kernel``."""
    s = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(s)
    for i, ch in enumerate(s):
        if ch in "<(":
            if depth == 0:
                cut = i
                break
        depth += ch == "<"
    s = s[:cut]
    return s.split("::")[-1] or name[:40]


@contextlib.contextmanager
def traced(device):
    """Profile the block; yields a dict that holds the reduced trace
    (``summarize``) once the block has closed."""
    from torch.profiler import ProfilerActivity, profile, record_function
    out = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            yield out
            torch.cuda.synchronize(device)
        out["wall_s"] = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    out.update(summarize(events))


def _stack_names(events):
    """Per thread, host operations as (start, end, name) sorted by start."""
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                   "user_annotation"):
            ops[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0),
                                  e["name"]))
    for v in ops.values():
        v.sort()
    return ops


def _open_at(ops: list, starts: list, ts: float) -> list:
    """The host operations of one thread open at ``ts``, outermost first."""
    i = bisect.bisect_right(starts, ts)
    open_ = [op for op in ops[max(0, i - 48):i] if op[1] >= ts]
    return open_


def _label(open_: list, after: str = "") -> str:
    """The innermost aten operation open, with the autograd node around it
    where there is one; with none open, the host is in Python, named by
    the operation it reaches next (``after``)."""
    node = next((n for _, _, n in reversed(open_)
                 if n.startswith("autograd::engine::evaluate_function")),
                None)
    inner = next((n for _, _, n in reversed(open_)
                  if n.startswith("aten::")), None)
    if inner is None:
        inner = (open_[-1][2] if open_ else
                 f"python before {after}" if after else "python")
    if node:
        return f"{node.split(': ')[-1]}/{inner}"
    return inner


def summarize(events: list) -> dict:
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = win[0]["ts"]
    w1 = w0 + win[0]["dur"]
    main_tid = win[0]["tid"]
    ops = _stack_names(events)
    starts = {tid: [o[0] for o in v] for tid, v in ops.items()}
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch[c] = (e["tid"], e["ts"])
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, d = e["ts"], e.get("dur", 0)
            if s + d < w0 or s > w1:
                continue
            dev.append((s, s + d, e))
    dev.sort(key=lambda x: x[0])
    by_name = collections.Counter()
    by_kernel = collections.Counter()
    launches = collections.Counter()
    for s, t, e in dev:
        kern = (short_kernel(e["name"]) if e["cat"] == "kernel"
                else e["name"].split(" (")[0])
        by_kernel[kern] += (t - s) * 1e-6
        launches[kern] += 1
        c = e.get("args", {}).get("correlation")
        host = "python"
        if c in launch:
            tid, ts = launch[c]
            host = _label(_open_at(ops[tid], starts[tid], ts))
        by_name[f"{host}:{kern}"] += (t - s) * 1e-6
    # union of device spans, and the gaps between them inside the window
    busy, gaps = 0.0, []
    cur = w0
    for s, t, _ in dev:
        s, t = max(s, w0), min(t, w1)
        if s > cur:
            gaps.append((cur, s))
        if t > cur:
            busy += t - max(s, cur)
            cur = t
    if w1 > cur:
        gaps.append((cur, w1))
    idle = collections.Counter()
    main, main_starts = ops[main_tid], starts[main_tid]
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(main_starts, mid)
        nxt = next((n for _, _, n in main[i:i + 64]
                    if n.startswith("aten::")), "the window's end")
        idle[_label(_open_at(main, main_starts, mid), nxt)] += (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "n_device_ops": len(dev),
            "kernel_s": dict(by_kernel), "kernel_launches": dict(launches),
            "device_ops": [[k, v] for k, v in by_name.most_common(10)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(10)]}
