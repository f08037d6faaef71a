"""Frustum gather of key Gaussians + KD-snap to db keypoints.

Port of ``splatloc_tpu.match.frustum`` (the reference's get_frusm_pts /
get_ref_keyponts_3d, test.py:247-302): project key Gaussians (marker >
thresh) into the database view with the raw K matrix (no half-pixel
shift), frustum-cull, back-project the db frame's score-mask pixels through
its depth, and snap each such 3D keypoint to the nearest in-frustum
Gaussian within 0.1 m. The scipy cKDTree becomes a brute-force nearest
neighbour, |x-y|^2 through one float32 matmul per block of queries (TF32
off: a TF32 product moves distances near the snap radius across it).

The JAX package pads the point sets to power-of-two buckets so XLA does not
recompile per query; eager torch needs no buckets, and the rows that come
out are the same.
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32


def project_points_K(pts: torch.Tensor, w2c: torch.Tensor, K: torch.Tensor,
                     width: int, height: int, near: float = 0.05):
    """Project with u = fx x/z + cx (reference test.py:255-262). Returns
    (uv [N,2], in_frustum [N])."""
    cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
    z = cam[:, 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    v = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    inside = (z > near) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    return torch.stack([u, v], -1), inside


@full_float32()
def nearest_neighbor(queries: torch.Tensor, points: torch.Tensor,
                     points_valid: torch.Tensor, block: int = 1024):
    """For each query [M,3], the nearest point among the valid ones of
    [N,3]. Returns (dist [M], index [M])."""
    sq_p = torch.sum(points * points, -1)
    big = torch.where(points_valid, 0.0, float("inf"))
    dists, idxs = [], []
    for s in range(0, queries.shape[0], block):
        qc = queries[s:s + block]
        cross = qc @ points.T
        d2 = (sq_p[None, :] - 2 * cross + torch.sum(qc * qc, -1)[:, None]
              + big)
        dmin, idx = torch.min(d2, dim=1)
        dists.append(torch.sqrt(torch.clamp(dmin, min=0.0)))
        idxs.append(idx)
    if not dists:
        return queries.new_zeros((0,)), torch.zeros(
            (0,), dtype=torch.int64, device=queries.device)
    return torch.cat(dists), torch.cat(idxs)


def backproject_mask(mask: np.ndarray, depth: np.ndarray, K: np.ndarray,
                     c2w: np.ndarray) -> np.ndarray:
    """Reference get_ref_keyponts_3d (test.py:287-302): back-project score-
    mask pixels through depth with the raw K (u - cx convention)."""
    ys, xs = np.nonzero(mask)
    d = depth[ys, xs]
    x = (xs - K[0, 2]) * d / K[0, 0]
    y = (ys - K[1, 2]) * d / K[1, 1]
    pc = np.stack([x, y, d], -1)
    return pc @ c2w[:3, :3].T + c2w[:3, 3]


def frustum_key_points(xyz: np.ndarray, marker: np.ndarray | None,
                       w2c: np.ndarray, K: np.ndarray,
                       width: int, height: int,
                       db_mask: np.ndarray | None = None,
                       db_depth: np.ndarray | None = None,
                       c2w: np.ndarray | None = None,
                       marker_thresh: float = 0.005,
                       snap_radius: float = 0.1,
                       subset: bool = False, device="cuda"):
    """The reference get_frusm_pts pipeline (test.py:247-285), on host
    arrays, computing on ``device``.

    Returns (pts3d [P,3], pts2d [P,2] in (u,v)). When ``subset`` (landmark
    selection eval) the marker filter and KD-snap are skipped
    (test.py:252-253,265-273).
    """
    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    uv, inside = project_points_K(dev(xyz), dev(w2c), dev(K), width, height)
    inside = inside.cpu().numpy()
    uv = uv.cpu().numpy()
    if not subset:
        inside = inside & (marker > marker_thresh)
    pts3d = xyz[inside]
    pts2d = uv[inside]
    if subset or db_mask is None:
        return pts3d, pts2d
    if pts3d.shape[0] == 0:
        return pts3d, pts2d

    kp3d = backproject_mask(db_mask, db_depth, K, c2w)
    if kp3d.shape[0] == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 2), np.float32)
    p = dev(pts3d)
    dist, idx = nearest_neighbor(dev(kp3d), p, torch.ones(
        (p.shape[0],), dtype=torch.bool, device=p.device))
    dist = dist.cpu().numpy()
    idx = idx.cpu().numpy()
    keep = dist < snap_radius
    return pts3d[idx[keep]], pts2d[idx[keep]]
