"""Profile the headline bench program on the card and print the top device
ops, aggregated over several steady-state iterations.

Port of ``tools/profile_bench.py``: ``bench.py``'s inputs at 640x480 with
100,000 Gaussians (fx = fy = 320) under the default pair-path caps
(``RasterConfig(use_pallas=True)``); ``iters`` gradient steps to all five
inputs are timed, then run again under ``torch.profiler`` (the card's
activity only, ``utils.profiling.trace``). Also holds the trace summarizer
the three profile tools share (``summarize``).

Run: python -m splatloc_tpu_torch.tools.profile_bench [iters]
     [--device cuda|cpu]          (cuda unless the CPU is asked for)
Prints the table on stderr and one JSON line: tool, ms_per_iter, mpix_s,
device_op_ms, device_idle_ms (the device numbers None where the trace
holds no device event, as on the CPU).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from splatloc_tpu_torch.tools.bench import (beat, build_kernels,
                                            cuda_device, draw_scene, synced,
                                            to_device)

# the Chrome trace's categories of work on the card's streams
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_trace(logdir) -> list:
    """The events of the one ``*.pt.trace.json`` that ``utils.profiling.
    trace`` wrote into ``logdir``."""
    files = sorted(Path(logdir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise RuntimeError(f"expected one trace in {logdir}: {files}")
    return json.loads(files[0].read_text()).get("traceEvents", [])


def summarize(events: list, iters: int, n_gaps: int = 10) -> dict:
    """Device-side complete events (kernels, copies and fills on the
    card's streams) of a trace over ``iters`` iterations:

    - ``ops``: per name, ms and launches an iteration, costliest first;
    - ``busy_ms``: the summed durations an iteration;
    - ``idle_ms``: the silences between the merged device spans an
      iteration (on one stream, the sum of the gaps between ops);
    - ``gaps``: the largest silences, each in us with the op that ended
      just before it.

    A trace without device events (a CPU run) gives an empty table and
    None for the times."""
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"ops": [], "busy_ms": None, "idle_ms": None, "gaps": []}
    durs, counts = collections.Counter(), collections.Counter()
    for e in dev:
        durs[e["name"]] += e.get("dur", 0)
        counts[e["name"]] += 1
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((s1 - e0, e0) for (_, e0), (s1, _) in
                   zip(merged, merged[1:])), reverse=True)
    ends = sorted((e["ts"] + e.get("dur", 0), e["name"]) for e in dev)
    end_ts = [t for t, _ in ends]

    def before(at):
        return ends[bisect.bisect_right(end_ts, at) - 1][1]
    return {
        "ops": [{"name": name, "ms": d / 1e3 / iters,
                 "count": counts[name] // iters}
                for name, d in durs.most_common()],
        "busy_ms": sum(durs.values()) / 1e3 / iters,
        "idle_ms": sum(g for g, _ in gaps) / 1e3 / iters,
        "gaps": [{"us": g, "after": before(at)} for g, at in gaps[:n_gaps]],
    }


def traced(fn, device) -> list:
    """Run ``fn`` under ``utils.profiling.trace`` and return the trace's
    events (the trace file goes to a temporary directory)."""
    from splatloc_tpu_torch.utils.profiling import trace
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp, device):
            fn()
        return load_trace(tmp)


def print_table(summary: dict, iters: int, unit: str = "iter",
                top_n: int = 70) -> None:
    """The summary as the JAX tools print theirs, on stderr."""
    if summary["busy_ms"] is None:
        print("== no device events in the trace", file=sys.stderr)
        return
    print(f"\n== device busy {summary['busy_ms']:.2f} ms/{unit}; idle "
          f"{summary['idle_ms']:.2f} ms/{unit}; top gaps (us): "
          f"{[int(g['us']) for g in summary['gaps']]}", file=sys.stderr)
    for g in summary["gaps"][:6]:
        print(f"  gap {int(g['us'])}us after {g['after'][:80]}",
              file=sys.stderr)
    print(f"\n== device ops over {iters} {unit}s", file=sys.stderr)
    for op in summary["ops"][:top_n]:
        print(f"{op['ms']:9.3f} ms/{unit}  x{op['count']:4d}  "
              f"{op['name'][:100]}", file=sys.stderr)
    sys.stderr.flush()


def rounded(x, nd: int = 2):
    return None if x is None else round(x, nd)


def make_inputs(H: int, W: int, N: int, device="cuda"):
    """(camera, the five inputs, the target) of the profile tools:
    ``bench.py``'s draws at fx = fy = 320."""
    from splatloc_tpu_torch.core.camera import Camera
    rng = np.random.default_rng(0)
    args = to_device(draw_scene(rng, N), device)
    tgt = torch.from_numpy(rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
                           ).to(device)
    cam = Camera.create(np.eye(4, dtype=np.float32), 320.0, 320.0,
                        W / 2, H / 2, W, H, device=device)
    return cam, args, tgt


def run(iters: int = 6, device="cuda", H: int = 480, W: int = 640,
        N: int = 100_000) -> dict:
    """Returns the result line (``result``) and the trace's summary."""
    from splatloc_tpu_torch.raster.types import RasterConfig
    from splatloc_tpu_torch.tools.bench import loss_fn

    dev = cuda_device(device, "profile_bench")
    build_kernels(dev)
    cam, args, tgt = make_inputs(H, W, N, dev)
    cfg = RasterConfig(use_pallas=True)

    def step():
        with torch.enable_grad():
            leaves = [p.detach().requires_grad_(True) for p in args]
            return torch.autograd.grad(loss_fn(leaves, cam, cfg, tgt),
                                       leaves)

    def steps():
        for _ in range(iters):
            step()
        synced(dev)

    t0 = time.perf_counter()
    step()
    synced(dev)
    beat(f"profile_bench: first step {time.perf_counter() - t0:.1f} s")
    step()
    synced(dev)
    tic = time.perf_counter()
    steps()
    dt = (time.perf_counter() - tic) / iters
    beat(f"steady {dt * 1e3:.2f} ms/iter -> {H * W / dt / 1e6:.2f} Mpix/s")
    summary = summarize(traced(steps, dev), iters)
    print_table(summary, iters)
    result = {"tool": "profile_bench", "ms_per_iter": round(dt * 1e3, 2),
              "mpix_s": round(H * W / dt / 1e6, 2),
              "device_op_ms": rounded(summary["busy_ms"]),
              "device_idle_ms": rounded(summary["idle_ms"])}
    return {"result": result, "summary": summary}


def main(iters: int = 6, device="cuda", **sizes) -> dict:
    """Prints and returns the result line; ``sizes`` (H, W, N) go to
    ``run``."""
    result = run(iters=iters, device=device, **sizes)["result"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="?", default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.iters, device=a.device)
