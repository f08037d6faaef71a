"""TSDF fusion of RGB-D frames + 3D feature-cloud extraction.

Port of ``splatloc_tpu.fields.fusion`` (the reference TSDFVolumeTorch,
utils/fusion_utils.py:112-319, and gen_3d_fusion_feature,
pre_process/gen_3d_fusion_feature.py:48-94): geometry (tsdf, weight,
colour) is fused densely on the device, surface points come from the
tsdf's zero-crossings along each axis, and the 256-d descriptors are fused
only at those points in a second pass over the frames.

Voxels and points are projected to the nearest pixel (``torch.round``,
half to even, as ``jnp.round``). The pixel is the rounded float32 product,
which the JAX package's CPU build may fuse into a multiply-add, so an
isolated voxel can take the neighbouring pixel on one side.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32


@dataclass
class TSDFVolume:
    origin: torch.Tensor     # [3] world coords of voxel (0,0,0) center
    voxel_size: float
    sdf_trunc: float
    tsdf: torch.Tensor       # [X,Y,Z], init 1.0
    weight: torch.Tensor     # [X,Y,Z]
    color: torch.Tensor      # [X,Y,Z,3] 0..255

    @classmethod
    def create(cls, bound: np.ndarray, voxel_size: float, margin: int = 3,
               device="cuda"):
        """bound: [3,2] min/max in meters."""
        bound = np.asarray(bound, np.float32)
        dims = np.ceil((bound[:, 1] - bound[:, 0]) / voxel_size).astype(int)
        X, Y, Z = (int(d) for d in dims)
        return cls(origin=torch.as_tensor(bound[:, 0], device=device),
                   voxel_size=float(voxel_size),
                   sdf_trunc=margin * float(voxel_size),
                   tsdf=torch.ones((X, Y, Z), device=device),
                   weight=torch.zeros((X, Y, Z), device=device),
                   color=torch.zeros((X, Y, Z, 3), device=device))


def _project(cam: torch.Tensor, K: torch.Tensor, W: int, H: int):
    """Camera-frame points [..., 3] -> (clipped pixel x, y, in-image mask,
    z), the nearest pixel of each."""
    z = cam[..., 2]
    zs = torch.where(z > 1e-6, z, torch.ones_like(z))
    px = torch.round(cam[..., 0] * K[0, 0] / zs + K[0, 2]).to(torch.int64)
    py = torch.round(cam[..., 1] * K[1, 1] / zs + K[1, 2]).to(torch.int64)
    inside = (px >= 0) & (px < W) & (py >= 0) & (py < H) & (z > 0)
    return px.clamp(0, W - 1), py.clamp(0, H - 1), inside, z


@full_float32()
def integrate_frame(vol: TSDFVolume, depth: np.ndarray, rgb: np.ndarray,
                    K: np.ndarray, c2w: np.ndarray,
                    obs_weight: float = 1.0) -> TSDFVolume:
    """One frame into the volume (rgb in [0,1] or 0..255 float, depth
    metric): round-to-nearest pixel lookup, truncated SDF running
    average."""
    dev = vol.tsdf.device
    rgb255 = rgb * 255.0 if rgb.max() <= 1.5 else rgb
    depth = torch.as_tensor(np.asarray(depth, np.float32), device=dev)
    rgb255 = torch.as_tensor(np.asarray(rgb255, np.float32), device=dev)
    K = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=dev)
    X, Y, Z = vol.tsdf.shape
    H, W = depth.shape
    grid = torch.stack(torch.meshgrid(
        torch.arange(X, dtype=torch.float32, device=dev),
        torch.arange(Y, dtype=torch.float32, device=dev),
        torch.arange(Z, dtype=torch.float32, device=dev), indexing="ij"), -1)
    world = grid * vol.voxel_size + vol.origin              # [X,Y,Z,3]
    del grid
    w2c = torch.linalg.inv(c2w)
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    del world
    pxc, pyc, inside, z = _project(cam, K, W, H)
    del cam
    d = depth[pyc, pxc]
    diff = d - z
    dist = torch.clamp(diff / vol.sdf_trunc, max=1.0)
    valid = inside & (d > 0) & (diff >= -vol.sdf_trunc)

    w_old = vol.weight
    w_new = torch.where(valid, w_old + obs_weight, w_old)
    denom = torch.clamp(w_new, min=1e-9)
    vol.tsdf = torch.where(valid, (w_old * vol.tsdf + obs_weight * dist)
                           / denom, vol.tsdf)
    c_new = rgb255[pyc, pxc]
    vol.color = torch.where(valid[..., None], torch.clamp(torch.round(
        (w_old[..., None] * vol.color + obs_weight * c_new)
        / denom[..., None]), 0, 255), vol.color)
    vol.weight = w_new
    return vol


def extract_surface_points(vol: TSDFVolume, max_points: int = 500_000,
                           min_weight: float = 1.0):
    """Zero-crossing surface samples -> (points [P,3], colors [P,3] 0..1),
    numpy float32.

    For each axis, adjacent voxel pairs with opposite tsdf sign (both
    observed) yield a linearly interpolated surface point, in C order of
    the lower voxel (``np.argwhere``'s); past ``max_points`` a subset is
    drawn with ``np.random.default_rng(0).choice``, as the JAX package
    draws it.
    """
    tsdf, weight, color = vol.tsdf, vol.weight, vol.color
    origin = vol.origin
    pts, cols = [], []
    for axis in range(3):
        n = tsdf.shape[axis]
        t0, t1 = tsdf.narrow(axis, 0, n - 1), tsdf.narrow(axis, 1, n - 1)
        w0, w1 = weight.narrow(axis, 0, n - 1), weight.narrow(axis, 1, n - 1)
        # sign change including exact zeros (counted once)
        change = ((t0 > 0) & (t1 <= 0)) | ((t0 <= 0) & (t1 > 0))
        cross = change & (w0 >= min_weight) & (w1 >= min_weight)
        idx = torch.nonzero(cross)
        if idx.shape[0] == 0:
            continue
        t0v, t1v = t0[cross], t1[cross]
        frac = t0v / torch.clamp(t0v - t1v, min=1e-9)
        p = idx.to(torch.float32)
        p[:, axis] += frac
        pts.append(p * vol.voxel_size + origin)
        cols.append(color.narrow(axis, 0, n - 1)[cross] / 255.0)
    if not pts:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32))
    points = torch.cat(pts, 0)
    colors = torch.cat(cols, 0)
    if points.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(points.shape[0], max_points,
                                              replace=False)
        sel = torch.from_numpy(sel).to(points.device)
        points, colors = points[sel], colors[sel]
    return (points.cpu().numpy().astype(np.float32),
            colors.cpu().numpy().astype(np.float32))


def save_volume(vol: TSDFVolume, path: str):
    """Persist the volume (reference utils/fusion_utils.py:295-311), in
    the JAX package's npz layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, origin=vol.origin.cpu().numpy(),
                        voxel_size=vol.voxel_size, sdf_trunc=vol.sdf_trunc,
                        tsdf=vol.tsdf.cpu().numpy(),
                        weight=vol.weight.cpu().numpy(),
                        color=vol.color.cpu().numpy())


def load_volume(path: str, device="cuda") -> TSDFVolume:
    with np.load(path) as z:
        def t(k):
            return torch.as_tensor(np.asarray(z[k], np.float32),
                                   device=device)
        return TSDFVolume(origin=t("origin"),
                          voxel_size=float(z["voxel_size"]),
                          sdf_trunc=float(z["sdf_trunc"]), tsdf=t("tsdf"),
                          weight=t("weight"), color=t("color"))


def fuse_point_features(points: np.ndarray, frames, K: np.ndarray,
                        feat_dim: int, depth_tol: float = 0.05,
                        min_weight: float = 1.0, device="cuda"):
    """Second pass: average dense descriptor maps onto the surface points.

    frames: iterable of (feat_hw [H,W,D] (a tensor on ``device`` or an
    array), depth [H,W], c2w [4,4]); a point takes a frame's descriptor
    where it projects inside and matches the depth map within
    ``depth_tol``. Returns (features [P,D] float32, weight [P]), numpy.
    """
    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    P = pts.shape[0]
    acc = torch.zeros((P, feat_dim), device=device)
    wsum = torch.zeros((P,), device=device)
    Kd = torch.as_tensor(np.asarray(K, np.float32), device=device)
    with full_float32():
        for feat_hw, depth, c2w in frames:
            feat_hw = torch.as_tensor(feat_hw, dtype=torch.float32,
                                      device=device)
            depth = torch.as_tensor(np.asarray(depth, np.float32),
                                    device=device)
            w2c = torch.linalg.inv(torch.as_tensor(
                np.asarray(c2w, np.float32), device=device))
            cam = pts @ w2c[:3, :3].T + w2c[:3, 3]
            H, W = depth.shape
            pxc, pyc, inside, z = _project(cam, Kd, W, H)
            d = depth[pyc, pxc]
            w = (inside & (d > 0) & (torch.abs(d - z) < depth_tol)).to(
                torch.float32)
            acc = acc + w[:, None] * feat_hw[pyc, pxc]
            wsum = wsum + w
    feats = acc / torch.clamp(wsum[:, None], min=1e-9)
    return feats.cpu().numpy().astype(np.float32), wsum.cpu().numpy()
