"""Offscreen 3-D localization replay — headless equivalent of the
reference's interactive Open3D viewer
(visualizations/render_localization_with_matches.py:206-425).

Per query frame it composes, from a fixed third-person viewpoint:
  - the scene mesh (vertex-splat z-buffer render, normal-shaded),
  - gt / predicted camera frusta (wireframes, reference create_camera_actor),
  - the growing gt / predicted trajectories,
  - 2D-3D match rays from matched landmarks to the predicted camera's image
    plane (reference visualize_match / project_2d_to_3d).

Everything is numpy + PIL — no GUI, no open3d — and the frames feed the same
write_replay PNG/mp4 writer used by the 2-D replay.

The port's own copy of ``splatloc_tpu.eval.replay3d``, on the port's
``fields.mesh`` and ``eval.visualize``.
"""
from __future__ import annotations

import os

import numpy as np
from PIL import Image, ImageDraw

# camera wireframe in camera space (reference CAM_POINTS/CAM_LINES layout:
# apex at the optical center, image rectangle at z=1, an "up" tick)
_CAM_POINTS = np.array([
    [0.0, 0.0, 0.0],
    [-1.0, -0.75, 1.0],
    [1.0, -0.75, 1.0],
    [1.0, 0.75, 1.0],
    [-1.0, 0.75, 1.0],
    [0.0, -1.0, 1.0],
    [-0.4, -0.75, 1.0],
    [0.4, -0.75, 1.0],
], np.float32)
_CAM_LINES = np.array([[1, 2], [2, 3], [3, 4], [4, 1], [1, 0], [0, 2],
                       [3, 0], [0, 4], [5, 6], [5, 7]])


def look_at_viewpoint(center: np.ndarray, extent: float,
                      elev: float = 0.55, azim: float = 0.0) -> np.ndarray:
    """A fixed third-person w2c looking at ``center`` from behind/above
    (the reference keeps a hand-tuned fixed_viewpoint; we derive one from
    the scene bounds)."""
    eye = center + extent * np.array(
        [np.sin(azim) * np.cos(elev), -np.sin(elev),
         -np.cos(azim) * np.cos(elev)], np.float32)
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, -1.0, 0.0], np.float32))
    nr = np.linalg.norm(right)
    right = (np.array([1.0, 0, 0], np.float32) if nr < 1e-6 else right / nr)
    up = np.cross(fwd, right)
    R = np.stack([right, up, fwd])            # rows: camera axes in world
    t = -R @ eye
    w2c = np.eye(4, dtype=np.float32)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    return w2c


def _project(K: np.ndarray, w2c: np.ndarray, pts: np.ndarray):
    """World points [N,3] -> (pixel uv [N,2], camera z [N])."""
    pc = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = pc[:, 2]
    zs = np.maximum(z, 1e-6)
    uv = (pc[:, :2] / zs[:, None]) @ np.diag([K[0, 0], K[1, 1]]) + K[:2, 2]
    return uv, z


def render_mesh_view(verts: np.ndarray, normals: np.ndarray | None,
                     colors: np.ndarray | None, K: np.ndarray,
                     w2c: np.ndarray, width: int, height: int,
                     point_px: int = 2) -> np.ndarray:
    """Painter's-algorithm vertex splat: project vertices, draw far-to-near
    so near splats overwrite far ones (a z-buffer without scatter-min), shade
    by |normal . view| (reference compute_vertex_normals + default shading).
    Returns float RGB [H,W,3] in [0,1]."""
    uv, z = _project(K, w2c, verts)
    ok = (z > 0.05) & (uv[:, 0] >= 0) & (uv[:, 0] < width - point_px) & \
         (uv[:, 1] >= 0) & (uv[:, 1] < height - point_px)
    uv, z = uv[ok], z[ok]
    if normals is not None:
        view = verts[ok] - np.linalg.inv(w2c)[:3, 3]
        view /= np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-9)
        lam = np.abs((normals[ok] * view).sum(1))
        shade = (0.25 + 0.75 * lam)[:, None] * np.array([[0.78, 0.78, 0.82]])
    else:
        zn = (z - z.min()) / max(z.max() - z.min(), 1e-6)
        shade = np.stack([0.9 - 0.5 * zn, 0.8 - 0.4 * zn,
                          0.9 - 0.2 * zn], -1)
    if colors is not None:
        shade = shade * colors[ok]
    order = np.argsort(-z)                     # far first
    ui = uv[order, 0].astype(np.int32)
    vi = uv[order, 1].astype(np.int32)
    img = np.zeros((height, width, 3), np.float32)
    for dy in range(point_px):
        for dx in range(point_px):
            img[vi + dy, ui + dx] = shade[order]
    return img


def _draw_lines(draw: ImageDraw.ImageDraw, K, w2c, p0s, p1s, color,
                width_px=1):
    """Project world-space segments and draw the ones fully in front."""
    uv0, z0 = _project(K, w2c, np.asarray(p0s, np.float32))
    uv1, z1 = _project(K, w2c, np.asarray(p1s, np.float32))
    for a, b, za, zb in zip(uv0, uv1, z0, z1):
        if za > 0.05 and zb > 0.05:
            draw.line([tuple(a), tuple(b)], fill=color, width=width_px)


def draw_camera(draw, K, w2c_view, c2w_cam, color, scale: float = 0.12):
    """Wireframe frustum of the camera with pose ``c2w_cam`` as seen from
    the replay viewpoint (reference create_camera_actor)."""
    pts = (_CAM_POINTS * scale) @ c2w_cam[:3, :3].T + c2w_cam[:3, 3]
    _draw_lines(draw, K, w2c_view, pts[_CAM_LINES[:, 0]],
                pts[_CAM_LINES[:, 1]], color, 2)


def image_plane_points(kp2d: np.ndarray, K_query: np.ndarray,
                       c2w_cam: np.ndarray, depth: float = 0.12):
    """Lift query keypoints onto the camera's z=depth image plane in world
    space (reference project_2d_to_3d)."""
    ones = np.ones((kp2d.shape[0], 1), np.float32)
    pc = (np.linalg.inv(K_query) @ np.hstack([kp2d, ones]).T).T * depth
    return pc @ c2w_cam[:3, :3].T + c2w_cam[:3, 3]


def replay3d_frame(mesh, K_view, w2c_view, width, height,
                   gt_poses, pred_poses, current: int,
                   matches: dict | None = None,
                   K_query: np.ndarray | None = None) -> np.ndarray:
    """One replay frame. ``mesh`` = (verts, normals|None, colors|None);
    poses are c2w [N,4,4]; ``matches`` holds 'pt3d' [M,3] and 'kp2d' [M,2]
    for the current query (reference update_mesh_and_pose body)."""
    verts, normals, colors = mesh
    img = render_mesh_view(verts, normals, colors, K_view, w2c_view,
                           width, height)
    im = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    d = ImageDraw.Draw(im)

    for traj, color in ((gt_poses[:current + 1], (60, 220, 60)),
                        (pred_poses[:current + 1], (255, 120, 30))):
        cs = traj[:, :3, 3]
        if len(cs) > 1:
            _draw_lines(d, K_view, w2c_view, cs[:-1], cs[1:], color, 1)
    draw_camera(d, K_view, w2c_view, gt_poses[current], (60, 220, 60))
    draw_camera(d, K_view, w2c_view, pred_poses[current], (255, 120, 30))

    if matches is not None and len(matches.get("pt3d", ())) > 0:
        pt3d = np.asarray(matches["pt3d"], np.float32)
        kp2d = np.asarray(matches["kp2d"], np.float32)
        Kq = K_view if K_query is None else K_query
        plane = image_plane_points(kp2d, Kq, pred_poses[current])
        _draw_lines(d, K_view, w2c_view, pt3d, plane, (40, 255, 40), 1)
    return np.asarray(im)


def render_localization_replay(mesh_path: str, gt_poses, pred_poses,
                               out_dir: str, width: int = 960,
                               height: int = 540, fov: float = 60.0,
                               matches_dir: str | None = None,
                               query_names: list[str] | None = None,
                               K_query: np.ndarray | None = None,
                               fps: int = 10):
    """Full offscreen replay: mesh.ply + pose arrays (+ optional per-query
    match npy dumps from cli/test.py --save_match, named {query}.npy with
    '2d'/'3d' arrays) -> PNG sequence + mp4. Mirrors the reference __main__
    flow (load mesh, filter, loop, video)."""
    from splatloc_tpu_torch.fields.mesh import load_mesh_ply
    from splatloc_tpu_torch.eval.visualize import write_replay

    verts, faces, normals, colors = load_mesh_ply(mesh_path)
    gt_poses = np.asarray(gt_poses, np.float32)
    pred_poses = np.asarray(pred_poses, np.float32)

    center = verts.mean(0)
    extent = 1.6 * float(np.linalg.norm(verts - center, axis=1).max())
    w2c_view = look_at_viewpoint(center, extent)
    f = 0.5 * width / np.tan(np.radians(fov) / 2)
    K_view = np.array([[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]],
                      np.float32)

    frames = []
    for i in range(len(pred_poses)):
        matches = None
        if matches_dir is not None and query_names is not None:
            p = os.path.join(matches_dir, f"{query_names[i]}.npy")
            if os.path.exists(p):
                mi = np.load(p, allow_pickle=True).item()
                matches = {"pt3d": mi["3d"], "kp2d": mi["2d"]}
        frames.append(replay3d_frame((verts, normals, colors), K_view,
                                     w2c_view, width, height, gt_poses,
                                     pred_poses, i, matches, K_query))
    write_replay(frames, out_dir, fps=fps)
    return frames
