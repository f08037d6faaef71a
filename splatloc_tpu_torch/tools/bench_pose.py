"""Secondary benchmark of the port: render-loss 6-DoF pose-optimization
iterations a second.

Port of ``bench_pose.py``: one iteration is a full differentiable render of
``bench.py``'s 100,000-Gaussian volume at 640x480, the gradient of
``mean|render(se3_exp(xi) @ w2c) - target|`` with respect to the SE(3)
twist, and ``xi - 1e-3 * grad``. The target is the scene's own render at
the identity pose. Renders take ``RasterConfig.for_device``: the pair
kernels on the card, the tiled blend on the CPU (the JAX program's
``use_pallas = default_backend() != "cpu"``). 50 iterations are issued
back to back after one warm step, with one synchronize at the end.

Run: python -m splatloc_tpu_torch.tools.bench_pose [--device cuda|cpu]
     [--iters 50]                 (cuda unless the CPU is asked for)
Prints one JSON line: metric, value, unit, vs_baseline.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from splatloc_tpu_torch.tools.bench import (beat, build_kernels,
                                            cuda_device, draw_scene, synced,
                                            to_device)

XI0 = (0.02, -0.01, 0.01, 0.005, -0.004, 0.006)


def make_inputs(H: int, W: int, N: int, device="cuda"):
    """(camera, the five inputs, the raster config) from
    ``default_rng(0)``, as ``bench_pose.py`` draws them."""
    from splatloc_tpu_torch.core.camera import Camera
    from splatloc_tpu_torch.raster.types import RasterConfig
    args = to_device(draw_scene(np.random.default_rng(0), N), device)
    cam = Camera.create(np.eye(4, dtype=np.float32), 320.0, 320.0,
                        W / 2, H / 2, W, H, device=device)
    return cam, args, RasterConfig.for_device(device)


def pose_loss(xi, args, cam, cfg, target):
    from splatloc_tpu_torch.core import transforms
    from splatloc_tpu_torch.raster import rasterize
    w2c = transforms.se3_exp(xi) @ cam.w2c
    out = rasterize(*args, cam.replace_pose(w2c), cfg)
    return torch.mean(torch.abs(out.image - target))


def pose_grad(xi, args, cam, cfg, target):
    with torch.enable_grad():
        xi = xi.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(pose_loss(xi, args, cam, cfg, target),
                                   [xi])
    return g


def step(xi, args, cam, cfg, target):
    return (xi - 1e-3 * pose_grad(xi, args, cam, cfg, target)).detach()


def run(device="cuda", iters: int = 50, H: int = 480, W: int = 640,
        N: int = 100_000) -> dict:
    """Returns the result line (``result``), the final twist ``xi`` and
    the target render's drop counters (n_dropped, n_trunc,
    n_vis_dropped)."""
    from splatloc_tpu_torch.raster import rasterize
    dev = cuda_device(device, "bench_pose")
    t0 = time.perf_counter()
    build_kernels(dev)
    cam, args, cfg = make_inputs(H, W, N, dev)
    with torch.no_grad():
        out = rasterize(*args, cam, cfg)
    target = out.image
    drops = (int(out.n_dropped), int(out.n_trunc), int(out.n_vis_dropped))
    xi0 = torch.tensor(XI0, dtype=torch.float32, device=dev)
    step(xi0, args, cam, cfg, target)
    synced(dev)
    beat(f"pose_opt: first step done; target drops {drops}", t0)
    tic = time.perf_counter()
    xi = xi0
    for _ in range(iters):
        xi = step(xi, args, cam, cfg, target)
    synced(dev)
    dt = time.perf_counter() - tic
    result = {"metric": "pose_opt", "value": round(iters / dt, 2),
              "unit": "iters/s", "vs_baseline": None}
    return {"result": result, "xi": xi, "drops": drops}


def main(device="cuda", iters: int = 50, **sizes) -> dict:
    """Prints and returns the result line; ``sizes`` (H, W, N) go to
    ``run``."""
    result = run(device=device, iters=iters, **sizes)["result"]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--iters", type=int, default=50)
    a = ap.parse_args()
    main(device=a.device, iters=a.iters)
