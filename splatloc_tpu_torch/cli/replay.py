"""Render the offscreen 3-D localization replay from saved eval artifacts.

Headless counterpart of the reference viewer's __main__ flow
(visualizations/render_localization_with_matches.py:300-425):
loads mesh.ply + the save_pose/ dumps written by `cli.test --save_pose`
(+ optionally the save_match/ dumps from --save_match), filters outlier
poses for a smooth trajectory, and writes a PNG sequence + mp4.

Port of ``splatloc_tpu.cli.replay`` (numpy and PIL; the dumps come from
the port's ``cli/test.py --save_pose --save_match``).

    python -m splatloc_tpu_torch.cli.replay --save_dir results/scene \
        --mesh results/scene/mesh.ply --out results/scene/replay3d
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _pose_mats(r: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Stack [N,3,3] rotations + [N,3] translations into c2w [N,4,4]."""
    n = r.shape[0]
    m = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    m[:, :3, :3] = r
    m[:, :3, 3] = t
    return m


def filter_outliers(pred: np.ndarray, gt: np.ndarray,
                    max_dist: float = 0.1) -> np.ndarray:
    """Keep queries localized within max_dist meters (reference
    filter_outlier) so the replay trajectory is smooth."""
    return np.linalg.norm(pred[:, :3, 3] - gt[:, :3, 3], axis=1) < max_dist


def main(argv=None):
    from splatloc_tpu_torch.eval.replay3d import render_localization_replay

    p = argparse.ArgumentParser()
    p.add_argument("--save_dir", required=True,
                   help="eval save dir containing save_pose/ (cli.test)")
    p.add_argument("--mesh", required=True, help="mesh.ply (gen_fusion)")
    p.add_argument("--out", required=True, help="output frame directory")
    p.add_argument("--width", type=int, default=960)
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--max_dist", type=float, default=0.1)
    p.add_argument("--fps", type=int, default=10)
    args = p.parse_args(argv)

    pose_dir = os.path.join(args.save_dir, "save_pose")
    gt = np.load(os.path.join(pose_dir, "gt.npy")).astype(np.float32)
    pred = _pose_mats(np.load(os.path.join(pose_dir, "match_r.npy")),
                      np.load(os.path.join(pose_dir, "match_t.npy")))
    keep = filter_outliers(pred, gt, args.max_dist)
    print(f"replay: {int(keep.sum())}/{len(keep)} queries kept "
          f"(<{args.max_dist} m)")

    match_dir = os.path.join(args.save_dir, "save_match")
    names = None
    if os.path.isdir(match_dir):
        names = sorted(os.path.splitext(f)[0]
                       for f in os.listdir(match_dir) if f.endswith(".npy"))
        names = [n for n, k in zip(names, keep) if k] \
            if len(names) == len(keep) else None

    frames = render_localization_replay(
        args.mesh, gt[keep], pred[keep], args.out, width=args.width,
        height=args.height, matches_dir=match_dir if names else None,
        query_names=names, fps=args.fps)
    print(f"wrote {len(frames)} frames to {args.out}")


if __name__ == "__main__":
    main()
