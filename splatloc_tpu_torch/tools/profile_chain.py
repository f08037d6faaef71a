"""Profile the chained bench program on the card: the per-iteration device
op totals and the device timeline's gaps.

Port of ``tools/profile_chain.py``: ``bench.py``'s chain of gradient steps,
each updating every input by ``p - 1e-12 * g``, issued back to back, at
640x480 with 100,000 Gaussians (fx = fy = 320), with the pair array sized
by the pair-need probe. The tile caps come from keywords whose defaults
are the JAX tool's; ``main`` reads them, as the JAX tool does, from
PC_MAX_TILES, PC_MID_K, PC_MID_TILES, PC_BIG_K and PC_BIG_TILES, and the
table's length from PROFILE_TOP_N.

Run: python -m splatloc_tpu_torch.tools.profile_chain [iters]
     [--device cuda|cpu]          (cuda unless the CPU is asked for)
Prints the table on stderr and one JSON line: tool, ms_per_iter, mpix_s,
device_busy_ms, device_idle_ms (the device numbers None where the trace
holds no device event, as on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time

from splatloc_tpu_torch.tools.bench import (beat, build_kernels,
                                            cuda_device, drop_count,
                                            grad_step, probe_caps, synced)
from splatloc_tpu_torch.tools.profile_bench import (make_inputs,
                                                    print_table, rounded,
                                                    summarize, traced)

# the JAX tool's cap defaults (tools/profile_chain.py:47-51)
CAPS = {"max_tiles": 6, "mid_k": 4096, "mid_tiles": 48, "big_k": 256,
        "big_tiles": 192}


def caps_from_env(environ=os.environ) -> dict:
    """CAPS, each overridden by its PC_<NAME> variable where set."""
    return {k: int(environ.get("PC_" + k.upper(), v))
            for k, v in CAPS.items()}


def run(iters: int = 10, device="cuda", H: int = 480, W: int = 640,
        N: int = 100_000, top_n: int = 30, **caps) -> dict:
    """Returns the result line (``result``), the trace's summary and the
    probed pair need. ``caps`` override CAPS."""
    from splatloc_tpu_torch.raster.types import RasterConfig

    dev = cuda_device(device, "profile_chain")
    build_kernels(dev)
    cam, args, tgt = make_inputs(H, W, N, dev)
    cfg = RasterConfig(use_pallas=True, **{**CAPS, **caps})
    cfg, need = probe_caps(cam, args, cfg, N, H, W)

    def chain(n):
        state = args
        for _ in range(n):
            state = grad_step(state, cam, cfg, tgt)
        synced(dev)

    t0 = time.perf_counter()
    chain(1)
    beat(f"profile_chain: first step {time.perf_counter() - t0:.1f} s")
    nd = drop_count(args, cam, cfg)
    beat(f"n_dropped={nd}")
    if nd != 0:
        raise AssertionError(f"cap experiment drops pairs: {nd}")
    chain(1)
    tic = time.perf_counter()
    chain(iters)
    dt = (time.perf_counter() - tic) / iters
    beat(f"steady {dt * 1e3:.2f} ms/iter -> {H * W / dt / 1e6:.2f} Mpix/s")
    summary = summarize(traced(lambda: chain(iters), dev), iters)
    print_table(summary, iters, top_n=top_n)
    result = {"tool": "profile_chain", "ms_per_iter": round(dt * 1e3, 2),
              "mpix_s": round(H * W / dt / 1e6, 2),
              "device_busy_ms": rounded(summary["busy_ms"]),
              "device_idle_ms": rounded(summary["idle_ms"])}
    return {"result": result, "summary": summary, "pair_need": need}


def main(iters: int = 10, device="cuda", **sizes) -> dict:
    """Prints and returns the result line; ``sizes`` (H, W, N) go to
    ``run``."""
    top_n = int(os.environ.get("PROFILE_TOP_N", "30"))
    result = run(iters=iters, device=device, top_n=top_n, **sizes,
                 **caps_from_env())["result"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("iters", type=int, nargs="?", default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.iters, device=a.device)
