"""Render-loss pose refinement benchmark of the port: the median pose error
after ``refine_pose`` from a known 5 cm / 5 deg start, and iterations a
second.

Port of ``tools/bench_refine.py``: ``quality_gate.make_gt_scene``'s
structured room (walls and clutter, smooth colors: a uniform random cloud
gives photometric refinement no basin) of 100,000 Gaussians at 640x480
(fx = fy = 320), the target rendered at the identity pose on
``RasterConfig.for_device`` (the pair kernels on the card, the tiled blend
on the CPU); per seed, a start pose 5 cm along a unit direction and 5 deg
about a unit axis from ``default_rng(100 + seed)``, refined by
``match.localize.refine_pose`` (100 iterations a level).

Run: python -m splatloc_tpu_torch.tools.bench_refine [n_seeds]
     [--device cuda|cpu]          (cuda unless the CPU is asked for)
Prints one JSON line with the JAX tool's keys; a line per seed on stderr.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from splatloc_tpu_torch.tools.bench import build_kernels, cuda_device, synced


def inv_sig(x):
    return np.log(x / (1 - x))


def make_scene(N: int, device="cuda"):
    """``make_gt_scene(N, default_rng(0))`` as a GaussianScene of capacity
    N: log scales, the clipped opacities' logits, colors as f_dc."""
    from splatloc_tpu_torch.scene.gaussians import GaussianScene
    from splatloc_tpu_torch.tools.quality_gate import make_gt_scene

    means, scales, quats, opac, colors = make_gt_scene(
        N, np.random.default_rng(0))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return GaussianScene.empty(N, device=device).replace(
        xyz=t(means), f_dc=t(colors[:, None, :]), scaling=t(np.log(scales)),
        rotation=t(quats),
        opacity=t(inv_sig(np.clip(opac, 0.01, 0.99))[:, None]
                  .astype(np.float32)),
        alive=torch.ones((N,), dtype=torch.bool, device=device))


def camera(W: int, H: int, device="cuda"):
    from splatloc_tpu_torch.core.camera import Camera
    return Camera.create(np.eye(4, dtype=np.float32), 320.0, 320.0,
                         (W - 1) / 2, (H - 1) / 2, W, H, device=device)


def start_twist(seed: int) -> np.ndarray:
    """5 cm along a unit direction and 5 deg about a unit axis, from
    ``default_rng(100 + seed)``."""
    srng = np.random.default_rng(100 + seed)
    axis = srng.normal(size=3)
    axis /= np.linalg.norm(axis)
    tdir = srng.normal(size=3)
    tdir /= np.linalg.norm(tdir)
    return np.concatenate([0.05 * tdir,                  # 5 cm
                           np.radians(5.0) * axis]).astype(np.float32)


def main(n_seeds: int = 5, N: int = 100_000, W: int = 640, H: int = 480,
         device="cuda", on_seed=None) -> dict:
    """The benchmark; prints and returns the result. ``on_seed(seed,
    rec)``, if given, sees each seed's start and final w2c, errors and
    refine_pose's info."""
    from splatloc_tpu_torch.core import transforms
    from splatloc_tpu_torch.match.localize import refine_pose
    from splatloc_tpu_torch.raster import RasterConfig, render

    dev = cuda_device(device, "bench_refine")
    build_kernels(dev)
    sc = make_scene(N, dev)
    cam = camera(W, H, dev)
    with torch.no_grad():
        gt_img = render(sc, cam, RasterConfig.for_device(dev))["render"]
    synced(dev)

    eye = torch.eye(4, device=dev)
    t_errs0, r_errs0, t_errs1, r_errs1, iters_all = [], [], [], [], []
    t_run = 0.0
    for seed in range(n_seeds):
        xi = torch.from_numpy(start_twist(seed)).to(dev)
        w2c0 = (transforms.se3_exp(xi) @ eye).cpu().numpy()

        t0, r0 = _pose_err(w2c0, np.eye(4))
        t_start = time.perf_counter()
        dxi, info = refine_pose(sc, cam, w2c0, gt_img, iters=100)
        synced(dev)
        t_run += time.perf_counter() - t_start
        w2c1 = (transforms.se3_exp(dxi)
                @ torch.from_numpy(w2c0).to(dev)).cpu().numpy()
        t1, r1 = _pose_err(w2c1, np.eye(4))
        t_errs0.append(t0); r_errs0.append(r0)
        t_errs1.append(t1); r_errs1.append(r1)
        iters_all.append(float(info["iters"]))
        print(f"[refine seed {seed}] {t0*100:.2f}cm/{r0:.2f}deg -> "
              f"{t1*100:.3f}cm/{r1:.3f}deg in {float(info['iters']):.0f} it",
              file=sys.stderr, flush=True)
        if on_seed is not None:
            on_seed(seed, {"w2c0": w2c0, "w2c1": w2c1, "t0": t0, "r0": r0,
                           "t1": t1, "r1": r1, "info": info})

    iters_per_s = sum(iters_all) / t_run
    res = {
        "metric": "pose_refine_5cm5deg",
        "median_t_cm": round(float(np.median(t_errs1)) * 100, 3),
        "median_r_deg": round(float(np.median(r_errs1)), 3),
        "start_t_cm": round(float(np.median(t_errs0)) * 100, 2),
        "start_r_deg": round(float(np.median(r_errs0)), 2),
        "t_reduction_x": round(float(np.median(t_errs0) /
                                     max(np.median(t_errs1), 1e-9)), 1),
        "r_reduction_x": round(float(np.median(r_errs0) /
                                     max(np.median(r_errs1), 1e-9)), 1),
        "iters_per_s": round(iters_per_s, 1),
        "n_seeds": n_seeds,
    }
    print(json.dumps(res), flush=True)
    return res


def _pose_err(w2c_a, w2c_b):
    """(translation m, rotation deg) between two w2c poses: the camera
    centers' distance and the geodesic rotation angle (the eval protocol
    of eval/metrics.py's pose_errors)."""
    ca = -w2c_a[:3, :3].T @ w2c_a[:3, 3]
    cb = -w2c_b[:3, :3].T @ w2c_b[:3, 3]
    t = float(np.linalg.norm(ca - cb))
    R = w2c_a[:3, :3] @ w2c_b[:3, :3].T
    r = float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))
    return t, r


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    a = ap.parse_args()
    main(a.n_seeds, device=a.device)
