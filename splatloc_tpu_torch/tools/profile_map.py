"""Profile the windowed mapping step on the card: the 5-view training
iteration that takes most of the wall clock of quality_gate and
train_gaussians.

Port of ``tools/profile_map.py``: a ``MappingTrainer`` at 640x480
(fx = fy = 320) with six keyframes of uniform random RGB and depth
(``default_rng(0)``, 0.05 m apart in x), its scene filled with random
Gaussians to ``n_alive`` (130,000), the active-set cap re-tiered and the
pair cap probe-tightened; then ``map(1)``, a timed ``map(iters)`` and a
``map(iters)`` under ``torch.profiler`` (the card's activity only).
PROFILE_TOP_N sets the table's length.

Run: python -m splatloc_tpu_torch.tools.profile_map [n_alive] [iters]
     [--device cuda|cpu]          (cuda unless the CPU is asked for)
Prints the table on stderr and one JSON line: tool, ms_per_step, it_s,
n_alive, capacity, device_op_ms (None where the trace holds no device
event, as on the CPU).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from splatloc_tpu_torch.tools.bench import (beat, build_kernels,
                                            cuda_device, synced)
from splatloc_tpu_torch.tools.profile_bench import (print_table, rounded,
                                                    summarize, traced)

N_KEYFRAMES = 6


def make_trainer(n_alive: int = 130_000, W: int = 640, H: int = 480,
                 fx: float = 320.0, device="cuda"):
    """(trainer, requested capacity): the JAX tool's trainer, keyframes
    and fill, with the visible cap re-tiered and the pair cap tightened."""
    from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer

    cfg = MappingConfig(width=W, height=H, fx=fx, fy=fx,
                        cx=(W - 1) / 2, cy=(H - 1) / 2)
    cap = 1 << int(np.ceil(np.log2(n_alive / 0.74)))
    trainer = MappingTrainer(cfg, capacity=cap, frame_capacity=8,
                             device=device)

    rng = np.random.default_rng(0)
    beat(f"capacity {cap}, target alive {n_alive}")
    # synthetic keyframes (content irrelevant for timing)
    for i in range(N_KEYFRAMES):
        rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        dep = rng.uniform(1.0, 8.0, (H, W)).astype(np.float32)
        sc = np.zeros((H, W), np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        trainer.add_keyframe(rgb, dep, sc, w2c)
    # fill slots [n0, n0 + add) with random Gaussians up to n_alive
    n0 = int(trainer.scene.num_alive)
    add = max(n_alive - n0, 0)
    s = trainer.scene
    sl = slice(n0, n0 + add)

    def filled(field, rows):
        out = field.clone()
        out[sl] = rows
        return out
    xyz = np.stack([rng.uniform(-3, 3, add), rng.uniform(-2, 2, add),
                    rng.uniform(1.0, 8.0, add)], -1).astype(np.float32)
    scaling = rng.uniform(-5.5, -3.5, (add, 3)).astype(np.float32)
    dev = s.xyz.device
    trainer.scene = s.replace(
        xyz=filled(s.xyz, torch.from_numpy(xyz).to(dev)),
        scaling=filled(s.scaling, torch.from_numpy(scaling).to(dev)),
        opacity=filled(s.opacity, 1.0), alive=filled(s.alive, True))
    # the fill bypasses add_keyframe, so re-tier the active-set cap for the
    # new alive count (the real pipeline does this on insertion), then
    # tighten the pair cap as steady-state mapping runs
    trainer._refresh_visible_cap()
    trainer.tighten_pair_cap()
    beat(f"alive {int(trainer.scene.num_alive)}, visible_cap "
         f"{trainer.cfg.visible_cap}, pair_override "
         f"{trainer.cfg.pair_cap_override}")
    return trainer, cap


def run(n_alive: int = 130_000, iters: int = 6, device="cuda", W: int = 640,
        H: int = 480, fx: float = 320.0, top_n: int = 60) -> dict:
    """Returns the result line (``result``), the trace's summary and the
    trainer."""
    dev = cuda_device(device, "profile_map")
    build_kernels(dev)
    trainer, cap = make_trainer(n_alive, W, H, fx, dev)

    t0 = time.perf_counter()
    trainer.map(1)
    synced(dev)
    beat(f"first step {time.perf_counter() - t0:.1f}s")
    tic = time.perf_counter()
    trainer.map(iters)
    synced(dev)
    dt = (time.perf_counter() - tic) / iters
    beat(f"steady {dt * 1e3:.1f} ms/step -> {1 / dt:.2f} it/s")

    def steps():
        trainer.map(iters)
        synced(dev)
    summary = summarize(traced(steps, dev), iters)
    print_table(summary, iters, unit="step", top_n=top_n)
    result = {"tool": "profile_map", "ms_per_step": round(dt * 1e3, 1),
              "it_s": round(1 / dt, 2), "n_alive": n_alive, "capacity": cap,
              "device_op_ms": rounded(summary["busy_ms"])}
    return {"result": result, "summary": summary, "trainer": trainer}


def main(n_alive: int = 130_000, iters: int = 6, device="cuda",
         **sizes) -> dict:
    """Prints and returns the result line; ``sizes`` (W, H, fx) go to
    ``run``."""
    top_n = int(os.environ.get("PROFILE_TOP_N", "60"))
    result = run(n_alive, iters, device=device, top_n=top_n,
                 **sizes)["result"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_alive", type=int, nargs="?", default=130_000)
    ap.add_argument("iters", type=int, nargs="?", default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.n_alive, a.iters, device=a.device)
