"""Screen-space projection of 3D Gaussians (EWA splatting).

Port of ``splatloc_tpu.raster.project``: frustum cull, 3D->2D projection,
J W Sigma W^T J^T covariance, low-pass blur, conic, radius and the
opacity-aware binning extents. Kept elementwise over [N] vectors, as in the
JAX package, so every value rounds the same way; ordinary autograd gives
gradients to every Gaussian parameter and to the camera pose.
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.core import transforms
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster.types import Projected, RasterConfig


def _rot_components(quats: torch.Tensor):
    """Rotation-matrix entries as nine [N] vectors (quat_to_matrix
    unrolled)."""
    q = transforms.quat_normalize(quats)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return ((1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
             2 * (x * z + w * y)),
            (2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
             2 * (y * z - w * x)),
            (2 * (x * z - w * y), 2 * (y * z + w * x),
             1 - 2 * (x * x + y * y)))


def _cov3d_components(scales: torch.Tensor, quats: torch.Tensor):
    """Symmetric world covariance R S S^T R^T as a {(j,k): [N]} dict of its
    entries."""
    R = _rot_components(quats)
    s0, s1, s2 = scales[..., 0], scales[..., 1], scales[..., 2]
    M = [[R[i][0] * s0, R[i][1] * s1, R[i][2] * s2] for i in range(3)]
    S = {}
    for j in range(3):
        for k in range(j, 3):
            S[(j, k)] = (M[j][0] * M[k][0] + M[j][1] * M[k][1]
                         + M[j][2] * M[k][2])
            S[(k, j)] = S[(j, k)]
    return S


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Scale (activated, [N,3]) + quaternion ([N,4], wxyz) -> 3D covariance
    [N,3,3]."""
    S = _cov3d_components(scales, quats)
    rows = [torch.stack([S[(j, 0)], S[(j, 1)], S[(j, 2)]], -1)
            for j in range(3)]
    return torch.stack(rows, dim=-2)


def project_gaussians(
    means3d: torch.Tensor,      # [N,3]
    scales: torch.Tensor,       # [N,3] activated (exp'd)
    quats: torch.Tensor,        # [N,4] unnormalized ok
    camera: Camera,
    cfg: RasterConfig,
    alive: torch.Tensor | None = None,      # [N] bool
    scaling_modifier: float = 1.0,
    opacities: torch.Tensor | None = None,  # [N] activated; tightens radius_xy
) -> Projected:
    w2c = camera.w2c
    R_cw = w2c[:3, :3]
    t_cw = w2c[:3, 3]

    p_view = torch.stack(
        [means3d[:, 0] * R_cw[i, 0] + means3d[:, 1] * R_cw[i, 1]
         + means3d[:, 2] * R_cw[i, 2] + t_cw[i] for i in range(3)], dim=-1)
    z = p_view[..., 2]
    in_front = z > cfg.near

    zs = torch.where(in_front, z, torch.ones_like(z))  # safe divisor
    x, y = p_view[..., 0], p_view[..., 1]
    u = camera.fx * x / zs + (camera.cx - 0.5)
    v = camera.fy * y / zs + (camera.cy - 0.5)

    # EWA: clamp the tangent-plane coords like the CUDA computeCov2D does
    limx = 1.3 * camera.tanfovx
    limy = 1.3 * camera.tanfovy
    txz = torch.minimum(torch.maximum(x / zs, -limx), limx)
    tyz = torch.minimum(torch.maximum(y / zs, -limy), limy)
    tx = txz * zs
    ty = tyz * zs

    fx, fy = camera.fx, camera.fy
    j00 = fx / zs
    j02 = -fx * tx / (zs * zs)
    j11 = fy / zs
    j12 = -fy * ty / (zs * zs)

    S = _cov3d_components(scales * scaling_modifier, quats)

    def covV(i, l):
        acc = 0.0
        for j in range(3):
            for k in range(3):
                acc = acc + R_cw[i, j] * R_cw[l, k] * S[(j, k)]
        return acc

    v00, v01, v02 = covV(0, 0), covV(0, 1), covV(0, 2)
    v11, v12, v22 = covV(1, 1), covV(1, 2), covV(2, 2)
    c00 = (j00 * (j00 * v00 + j02 * v02)
           + j02 * (j00 * v02 + j02 * v22))
    c01 = (j11 * (j00 * v01 + j02 * v12)
           + j12 * (j00 * v02 + j02 * v22))
    c11 = (j11 * (j11 * v11 + j12 * v12)
           + j12 * (j11 * v12 + j12 * v22))

    c00 = c00 + cfg.cov2d_blur
    c11 = c11 + cfg.cov2d_blur

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    det_safe = torch.where(det_ok, det, torch.ones_like(det))
    inv_det = 1.0 / det_safe
    conic_a = c11 * inv_det
    conic_b = -c01 * inv_det
    conic_c = c00 * inv_det

    mid = 0.5 * (c00 + c11)
    lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det_safe, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lambda1))

    visible = in_front & det_ok
    if alive is not None:
        visible = visible & alive

    # tile-overlap cull identical to CUDA getRect: zero-area rect => invisible
    ts = float(cfg.tile_size)
    gx = float(-(-camera.width // cfg.tile_size))
    gy = float(-(-camera.height // cfg.tile_size))
    rect_min_x = torch.clamp(torch.floor((u - radius) / ts), 0, gx)
    rect_max_x = torch.clamp(torch.floor((u + radius) / ts) + 1, 0, gx)
    rect_min_y = torch.clamp(torch.floor((v - radius) / ts), 0, gy)
    rect_max_y = torch.clamp(torch.floor((v + radius) / ts) + 1, 0, gy)
    nonempty = (rect_max_x - rect_min_x) * (rect_max_y - rect_min_y) > 0
    visible = visible & nonempty

    zero = torch.zeros_like(radius)
    radius = torch.where(visible, radius, zero)

    # per-axis binning extents: the ellipse's axis-aligned bounding box at
    # the opacity-aware cutoff alpha >= alpha_min, intersected with the
    # square radius (every pixel of a tile it excludes has
    # alpha < alpha_min); 0.05 slack absorbs f32 rounding at the boundary
    if opacities is not None and cfg.aabb_binning:
        c_cut = 2.0 * torch.log(torch.clamp(opacities, min=1e-12)
                                / cfg.alpha_min) + 0.05
        s_cut = torch.sqrt(torch.clamp(c_cut, min=0.0))
        rx = torch.minimum(s_cut * torch.sqrt(torch.clamp(c00, min=0.0)),
                           radius)
        ry = torch.minimum(s_cut * torch.sqrt(torch.clamp(c11, min=0.0)),
                           radius)
        rx = torch.where(visible, rx, zero)
        ry = torch.where(visible, ry, zero)
    else:
        rx = ry = radius
    return Projected(u=u, v=v, depth=z, conic_a=conic_a, conic_b=conic_b,
                     conic_c=conic_c, radius=radius, visible=visible,
                     radius_x=rx, radius_y=ry)
