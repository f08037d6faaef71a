"""Render-loss pose refinement's basin, quantified: perturb the ground-truth
pose by a known magnitude, refine, report the median final pose error.

Port of ``tools/refine_table.py``: 160x120, 500 Gaussians, six start
errors from 1 cm / 1 deg to 15 cm / 12 deg, ``seeds`` seeds a row. The
target is rendered through the tiled blend (``RasterConfig(tile_chunk=8)``)
and ``refine_pose`` takes the device's raster path (the pair kernels on the
card, the tiled blend on the CPU).

Run: python -m splatloc_tpu_torch.tools.refine_table [--device cuda|cpu]
     [--seeds 3]                 (cuda unless the CPU is asked for)
Prints a markdown table and one JSON line of the rows.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# (start translation error in m, start rotation error in deg) of each row
ROWS = ((0.01, 1.0), (0.03, 3.0), (0.055, 5.0), (0.10, 8.0), (0.10, 10.0),
        (0.15, 12.0))


def make_scene(r, n=500, cap=512, device="cuda"):
    from splatloc_tpu_torch.scene.gaussians import GaussianScene

    sc = GaussianScene.empty(cap, device=device)
    pad = lambda a: np.concatenate(
        [a, np.zeros((cap - n,) + a.shape[1:], a.dtype)], 0)
    quats = r.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    alive = np.zeros(cap, bool); alive[:n] = True

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return sc.replace(
        xyz=t(pad(np.stack([r.uniform(-1, 1, n),
                            r.uniform(-0.8, 0.8, n),
                            r.uniform(1.2, 4.0, n)], -1)
                  .astype(np.float32))),
        scaling=t(pad(r.uniform(-4.2, -2.8, (n, 3)).astype(np.float32))),
        rotation=t(np.concatenate(
            [quats, np.tile([[1, 0, 0, 0]], (cap - n, 1))
             .astype(np.float32)], 0)),
        opacity=t(pad(r.uniform(0.5, 2.5, (n, 1)).astype(np.float32))),
        f_dc=t(pad(r.uniform(0, 1, (n, 1, 3)).astype(np.float32))),
        alive=t(alive))


def pose_err(T, T_gt):
    d = T @ np.linalg.inv(T_gt)
    t = float(np.linalg.norm(d[:3, 3]))
    c = (np.trace(d[:3, :3]) - 1) / 2
    r = float(np.degrees(np.arccos(np.clip(c, -1, 1))))
    return t, r


def camera(device):
    from splatloc_tpu_torch.core.camera import Camera
    return Camera.create(np.eye(4, dtype=np.float32), 120., 120., 80., 60.,
                         160, 120, device=device)


def refine_case(tmag: float, rdeg: float, seed: int, device="cuda",
                iters: int = 120) -> dict:
    """One refinement of the table: the scene and then the start pose
    drawn from ``default_rng(seed)``, as the JAX tool draws them, and
    ``refine_pose`` at lr 2e-3 with ``iters`` iterations a level. Returns
    the start and final errors (m, deg), the wall seconds, the final w2c
    and refine_pose's info."""
    from splatloc_tpu_torch.core import transforms
    from splatloc_tpu_torch.match.localize import refine_pose
    from splatloc_tpu_torch.raster import RasterConfig, render

    dev = torch.device(device)
    cam = camera(dev)
    r = np.random.default_rng(seed)
    scene = make_scene(r, device=dev)
    with torch.no_grad():
        gt = render(scene, cam, RasterConfig(tile_chunk=8))["render"]
    # the start pose: the ground truth (the identity) moved by tmag along a
    # random direction and turned by rdeg about a random axis
    ax = r.normal(size=3); ax = ax / np.linalg.norm(ax)
    tv = r.normal(size=3); tv = tv / np.linalg.norm(tv) * tmag
    xi_true = np.concatenate([tv, ax * np.radians(rdeg)]).astype(np.float32)
    T0 = transforms.se3_exp(torch.from_numpy(xi_true).to(dev))
    t0, r0 = pose_err(T0.cpu().numpy(), np.eye(4))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    tic = time.perf_counter()
    xi, info = refine_pose(scene, cam, T0, gt, iters=iters, lr=2e-3)
    Tf = (transforms.se3_exp(xi) @ T0).cpu().numpy()
    secs = time.perf_counter() - tic
    t1, r1 = pose_err(Tf, np.eye(4))
    return {"t0": t0, "r0": r0, "t1": t1, "r1": r1, "secs": secs,
            "w2c": Tf, "info": info}


def main(device="cuda", seeds: int = 3) -> list:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("refine_table: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    rows = []
    for tmag, rdeg in ROWS:
        cases = [refine_case(tmag, rdeg, seed, dev) for seed in range(seeds)]

        def med(k):
            return float(np.median([c[k] for c in cases]))
        rows.append({"start_cm": tmag * 100, "start_deg": rdeg,
                     "start_t_cm": med("t0") * 100, "t_err_cm": med("t1") * 100,
                     "start_r_deg": med("r0"), "r_err_deg": med("r1"),
                     "wall_s": med("secs"), "seeds": seeds})
        print(f"done eps={tmag*100:.1f}cm/{rdeg:.0f}deg", file=sys.stderr,
              flush=True)
    print("| start err (cm / deg) | median final t err (cm) | "
          "median final r err (deg) | median wall (s) |")
    print("|---|---|---|---|")
    for row in rows:
        print(f"| {row['start_cm']:.1f} / {row['start_deg']:.0f} | "
              f"{row['t_err_cm']:.3f} | {row['r_err_deg']:.3f} | "
              f"{row['wall_s']:.1f} |")
    print(json.dumps({"device": str(dev), "rows": rows}), flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    main(device=args.device, seeds=args.seeds)
