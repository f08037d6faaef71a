"""Visualization utilities (reference visualizations/ + debug dumps).

Port of ``splatloc_tpu.eval.visualize``; the renders go through the port's
``render`` on the scene's device. The reference's interactive Open3D GUI replay (render_localization*.py,
~1100 LoC) depends on open3d + OpenGL, absent here; these produce the same
artifacts headlessly with PIL/matplotlib:

- match drawing (utils/vis_match_utils.py:200-224 vis_matches)
- PCA feature-map -> RGB (utils/vis_feat_utils.py:11-33)
- localization replay frames: rendered view vs query + top-down trajectory
  with pred/gt camera axes (render_localization.py equivalents), writable
  as PNG sequences (assemble to mp4 with any encoder)
- debug render dumps: rgb / jet-depth / jet-opacity per keyframe
  (train_gaussians.py:94-171 debug())
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw


def _to_u8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def colormap_jet(x: np.ndarray, vmin=None, vmax=None) -> np.ndarray:
    """[H,W] -> [H,W,3] float jet colormap (imgviz.depth2rgb equivalent)."""
    vmin = np.nanmin(x) if vmin is None else vmin
    vmax = np.nanmax(x) if vmax is None else vmax
    t = np.clip((x - vmin) / max(vmax - vmin, 1e-9), 0, 1)
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return np.stack([r, g, b], -1)


def draw_matches(img_a: np.ndarray, img_b: np.ndarray, kp_a: np.ndarray,
                 kp_b: np.ndarray, inliers: np.ndarray | None = None,
                 max_draw: int = 200) -> np.ndarray:
    """Side-by-side keypoint match image (kp in (u,v) pixel coords)."""
    ha, wa = img_a.shape[:2]
    hb, wb = img_b.shape[:2]
    H = max(ha, hb)
    canvas = np.zeros((H, wa + wb, 3), np.uint8)
    canvas[:ha, :wa] = _to_u8(img_a)
    canvas[:hb, wa:wa + wb] = _to_u8(img_b)
    im = Image.fromarray(canvas)
    d = ImageDraw.Draw(im)
    n = min(len(kp_a), max_draw)
    for i in range(n):
        ok = True if inliers is None else bool(inliers[i])
        color = (0, 255, 0) if ok else (255, 64, 64)
        ax, ay = float(kp_a[i, 0]), float(kp_a[i, 1])
        bx, by = float(kp_b[i, 0]) + wa, float(kp_b[i, 1])
        d.line([(ax, ay), (bx, by)], fill=color, width=1)
        d.ellipse([ax - 2, ay - 2, ax + 2, ay + 2], outline=color)
        d.ellipse([bx - 2, by - 2, bx + 2, by + 2], outline=color)
    return np.asarray(im)


def feature_pca_rgb(feat: np.ndarray) -> np.ndarray:
    """[H,W,D] feature map -> [H,W,3] PCA visualization."""
    H, W, D = feat.shape
    f = feat.reshape(-1, D)
    f = f - f.mean(0, keepdims=True)
    # top-3 principal components via covariance eigendecomposition
    cov = f.T @ f / max(len(f) - 1, 1)
    vals, vecs = np.linalg.eigh(cov)
    basis = vecs[:, -3:]
    proj = f @ basis
    lo, hi = np.percentile(proj, 2, axis=0), np.percentile(proj, 98, axis=0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
    return rgb.reshape(H, W, 3)


def save_debug_renders(scene, camera, save_dir: str, uid, raster_cfg=None):
    """Per-keyframe rgb / depth(jet) / opacity(jet) dumps
    (train_gaussians.py debug())."""
    import torch
    from splatloc_tpu_torch.raster import render
    from splatloc_tpu_torch.raster.types import RasterConfig
    cfg = raster_cfg or RasterConfig()
    with torch.no_grad():
        out = {k: v.cpu().numpy() for k, v in render(scene, camera,
                                                     cfg).items()}
    for sub in ("rgb", "depth", "opacity"):
        os.makedirs(os.path.join(save_dir, "rendering", sub), exist_ok=True)
    rgb = _to_u8(out["render"])
    Image.fromarray(rgb).save(
        os.path.join(save_dir, "rendering", "rgb", f"rgb_{uid}.png"))
    dep = out["depth"]
    Image.fromarray(_to_u8(colormap_jet(dep, 0.1, max(dep.max(), 0.2)))).save(
        os.path.join(save_dir, "rendering", "depth", f"depth_{uid}.png"))
    alp = out["opacity"]
    Image.fromarray(_to_u8(colormap_jet(alp, 0.0, max(alp.max(), 1e-6)))).save(
        os.path.join(save_dir, "rendering", "opacity", f"opacity_{uid}.png"))


def replay_frame(render_rgb: np.ndarray, query_rgb: np.ndarray,
                 traj_gt: np.ndarray, traj_pred: np.ndarray,
                 current: int) -> np.ndarray:
    """One localization-replay frame: rendered view | query view | top-down
    trajectory (gt blue, pred orange, current highlighted)."""
    h, w = query_rgb.shape[:2]
    pane = np.zeros((h, w, 3), np.float32)
    pts = np.concatenate([traj_gt[:, [0, 2]], traj_pred[:, [0, 2]]], 0)
    lo, hi = pts.min(0) - 0.3, pts.max(0) + 0.3
    scale = min((w - 20) / max(hi[0] - lo[0], 1e-6),
                (h - 20) / max(hi[1] - lo[1], 1e-6))

    def to_px(p):
        return (10 + (p[0] - lo[0]) * scale, 10 + (p[1] - lo[1]) * scale)

    im = Image.fromarray(_to_u8(pane))
    d = ImageDraw.Draw(im)
    for traj, color in ((traj_gt, (80, 140, 255)),
                        (traj_pred, (255, 160, 40))):
        px = [to_px(p) for p in traj[:, [0, 2]]]
        if len(px) > 1:
            d.line(px, fill=color, width=1)
        for i, p in enumerate(px):
            r = 4 if i == current else 2
            d.ellipse([p[0] - r, p[1] - r, p[0] + r, p[1] + r], fill=color)
    pane = np.asarray(im)
    strip = np.concatenate([_to_u8(render_rgb), _to_u8(query_rgb), pane],
                           axis=1)
    return strip


def write_replay(frames: list[np.ndarray], out_dir: str, fps: int = 10):
    """PNG sequence (+ mp4 if imageio has an encoder available)."""
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(out_dir, f"frame_{i:05d}.png"))
    try:
        import imageio.v2 as imageio
        imageio.mimsave(os.path.join(out_dir, "replay.mp4"), frames, fps=fps)
    except Exception:
        pass
