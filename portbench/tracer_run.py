"""The port's tracer (``utils.profiling.span`` / ``count``) on the card:
what its spans and counters read, and what they cost.

    python3 -m portbench.tracer_run --seed <n>

Sets up the programs of the cells ``map.replica_room0`` and
``localize.replica_room0`` with their generators' ``prepare`` and warms
them up as the generators' ``run`` does (the trainer to its window, the
Localizer through the largest frustums), then, for each:

- counts the host syncs (``utils.profiling.count_syncs``) of one
  ``map(10)`` and of one query, tracer off and on;
- times ``TURNS`` turns off, on, on, off, ...: three ``map(10)`` calls
  (ms a step; a chunk that would densify or reset opacities runs untimed
  first) or 8 queries (ms a query). Each pair of neighbouring turns holds
  one of each mode; the on-cost is the median over pairs of on / off - 1,
  so a drift of the host's speed across the run cancels;
- reads the spans and counters of the on turns (``spans.readings``, the
  host ms of every span a step or query, and the share of the wall the
  request's children cover), and the drop counters of the untimed chunks
  that densify, which run with the tracer on;
- profiles one chunk (the cell's ``chunk_iters``) and the cell's
  ``traced_queries`` queries with the tracer on, as a ``--trace 1`` run
  profiles them: ``spans.idle_by_span``, its sum against
  ``profile.summarize``'s idle time, and ``profile.summarize``'s
  ``idle_gaps`` beside it;
- times 100,000 empty spans off and on on the card's host: their cost
  times the spans a step or query records, over its wall, is what the
  spans themselves add, which the turns' spread may hide.

Prints one JSON line with the card's name and power limit. Needs a card.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

from portbench import harness

harness.set_process_env()

TURNS = 16
CHUNKS_A_TURN = 3
QUERIES_A_TURN = 8


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def modes() -> list:
    """off, on, on, off, off, on, ... (``TURNS`` of them)."""
    return [("off", "on", "on", "off")[i % 4] for i in range(TURNS)]


def traced_as(mode: str, fn, got: list | None = None):
    """fn() with the tracer in ``mode``; what it recorded (``drain()``) is
    appended to ``got``."""
    from splatloc_tpu_torch.utils import profiling
    profiling.drain()
    if mode == "on":
        profiling.enable()
    try:
        return fn()
    finally:
        profiling.disable()
        rec = profiling.drain()
        if got is not None:
            got.append(rec)


def merged(got: list) -> dict:
    """Several ``drain()`` records as one."""
    counters = collections.Counter()
    for g in got:
        counters.update(g["counters"])
    return {"spans": [s for g in got for s in g["spans"]],
            "counters": dict(counters),
            "spans_dropped": sum(g["spans_dropped"] for g in got)}


def profiled_events(dev, fn) -> list:
    """The host and device events of a torch.profiler window around fn(),
    marked as ``profile.traced`` marks its window (which keeps only the
    reduced trace, not the events ``spans.idle_by_span`` needs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench.profile import WINDOW
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize(dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def idle_reading(events: list) -> dict:
    from portbench import profile, spans
    s = profile.summarize(events)
    idle = spans.idle_by_span(events)
    return {"window_s": s["window_s"], "busy_s": s["busy_s"],
            "idle_by_span": idle,
            "idle_sum_minus_idle_s": (sum(idle.values())
                                      - (s["window_s"] - s["busy_s"])),
            "idle_gaps": s["idle_gaps"]}


def span_reading(got: list, request: str, wall_ms: float) -> dict:
    """What the on turns' spans and counters read, a step or a query."""
    from portbench import spans
    rec = merged(got)
    n = sum(s.name == request for s in rec["spans"])
    kids = spans.children_ms(rec["spans"], request)
    return {"readings": spans.readings(rec),
            "host_ms": spans.host_ms(rec["spans"], request),
            "children_ms": kids, "wall_ms": wall_ms,
            "children_share_pct": (None if kids is None
                                   else 100 * kids / wall_ms),
            "spans_each": len(rec["spans"]) / max(n, 1),
            "counters": rec["counters"],
            "spans_dropped": rec["spans_dropped"]}


def span_ns(n: int = 100_000) -> dict:
    """Host ns an empty span costs, tracer off and on."""
    from splatloc_tpu_torch.utils import profiling

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("portbench.empty"):
                pass
        return (time.perf_counter_ns() - t0) / n
    return {mode: traced_as(mode, loop) for mode in ("off", "on")}


def on_wall_ms(ms: list) -> float:
    return statistics.mean(m for m, mode in zip(ms, modes()) if mode == "on")


def mapping(seed: int, dev) -> dict:
    import torch
    from portbench import spans
    from portbench.generators import mapping as gen
    from splatloc_tpu_torch.utils.profiling import count_syncs
    cell = harness.find_cell("map.replica_room0")
    tr = cell.traffic
    pre = gen.prepare(cell, seed, dev)
    trainer, mcfg = pre["trainer"], pre["mcfg"]
    chunk = tr["chunk_iters"]
    while trainer.iteration < tr["warmup_iters"]:
        trainer.map(min(chunk, tr["warmup_iters"] - trainer.iteration))

    sched = []

    def clear_of_schedule():
        """Run chunks untimed, tracer on, until the next holds no densify
        or reset (the drop counters are added at the densify)."""
        while any(i % mcfg.gaussian_update_every
                  == mcfg.gaussian_update_offset
                  or i % mcfg.gaussian_reset == 0
                  for i in range(trainer.iteration + 1,
                                 trainer.iteration + chunk + 1)):
            traced_as("on", lambda: trainer.map(chunk), sched)

    syncs = {}
    for mode in ("off", "on"):
        clear_of_schedule()
        _, syncs[mode] = traced_as(
            mode, lambda: count_syncs(lambda: trainer.map(chunk)))
    ms, got = [], []
    for mode in modes():
        t = 0.0
        for _ in range(CHUNKS_A_TURN):
            clear_of_schedule()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            traced_as(mode, lambda: trainer.map(chunk), got)
            torch.cuda.synchronize(dev)
            t += time.perf_counter() - t0
        ms.append(t * 1e3 / (chunk * CHUNKS_A_TURN))
    clear_of_schedule()
    events = traced_as("on", lambda: profiled_events(
        dev, lambda: trainer.map(chunk)))
    idle = idle_reading(events)
    idle["idle_in_backward_pct"] = 100 * idle["idle_by_span"].get(
        "map.step.backward", 0.0) / idle["window_s"]
    dropped = merged(sched)["counters"]
    return {"syncs": syncs, "ms": ms,
            "spans": span_reading(got, "map.step", on_wall_ms(ms)),
            "scheduled_chunks": {
                "counters": dropped,
                "pairs_dropped_per_step": spans.readings(
                    {"counters": dropped})["pairs_dropped_per_step"]},
            "profiled_chunk": idle}


def localize(seed: int, dev) -> dict:
    import numpy as np
    import torch
    from portbench.generators import localize as gen
    from splatloc_tpu_torch.utils.profiling import count_syncs
    cell = harness.find_cell("localize.replica_room0")
    tr = cell.traffic
    pre = gen.prepare(cell, seed, dev)
    loc = pre["loc"]
    for q in np.argsort(pre["sizes"])[::-1][:tr["warmup_queries"]]:
        loc.localize({}, f"q{int(q)}")
    syncs = {}
    for mode in ("off", "on"):
        _, syncs[mode] = traced_as(
            mode, lambda: count_syncs(lambda: loc.localize({}, "q0")))
    ms, got = [], []
    pos = 0
    for mode in modes():
        t = 0.0
        for _ in range(QUERIES_A_TURN):
            name = f"q{gen.qid(pre, pos)}"
            pos += 1
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            traced_as(mode, lambda: loc.localize({}, name), got)
            t += time.perf_counter() - t0
        ms.append(t * 1e3 / QUERIES_A_TURN)

    def profiled_queries():
        for q in range(tr["traced_queries"]):
            loc.localize({}, f"q{gen.qid(pre, pos + q)}")
    events = traced_as("on", lambda: profiled_events(dev, profiled_queries))
    loc.untap()
    return {"syncs": syncs, "ms": ms,
            "spans": span_reading(got, "localize.query", on_wall_ms(ms)),
            "profiled_queries": idle_reading(events)}


def on_cost_pct(ms: list) -> float:
    """Median over neighbouring pairs of turns of on / off - 1, in %."""
    turns = modes()
    pairs = [dict(zip(turns[i:i + 2], ms[i:i + 2]))
             for i in range(0, len(ms) - 1, 2)]
    return statistics.median(100 * (p["on"] / p["off"] - 1) for p in pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(harness.CPU_THREADS)
    if not torch.cuda.is_available():
        print("tracer_run: needs a CUDA device", file=sys.stderr)
        return 2
    harness.bind_kernel_cache()
    dev = torch.device("cuda", 0)
    out = {"card": power_limit() or torch.cuda.get_device_name(dev),
           "seed": args.seed, "turns": modes(), "span_ns": span_ns()}
    out["map"] = mapping(args.seed, dev)
    torch.cuda.empty_cache()
    out["localize"] = localize(args.seed, dev)
    extra_ns = out["span_ns"]["on"] - out["span_ns"]["off"]
    for kind in ("map", "localize"):
        r = out[kind]
        r["on_cost_pct"] = on_cost_pct(r["ms"])
        r["span_cost_pct"] = 100 * r["spans"]["spans_each"] * extra_ns \
            * 1e-6 / statistics.median(r["ms"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
