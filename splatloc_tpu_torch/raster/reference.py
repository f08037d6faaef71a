"""Slow exact per-pixel compositor: the oracle of the tiled rasterizer.

Port of ``splatloc_tpu.raster.reference``. No tiling and no capacity
limits: every pixel walks the whole depth-sorted Gaussian list, with the
tiled blend's math (the same clamps and termination). Tests hold binning,
capacity handling and tile assembly against it. O(H*W*N) memory and
compute: small inputs only.
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, project
from splatloc_tpu_torch.raster.types import RasterConfig


def rasterize_reference(means3d, scales, quats, opacities, colors,
                        camera: Camera, cfg: RasterConfig = RasterConfig(),
                        bg=None, alive=None, pixels=None):
    """Returns (image [H,W,C], depth [H,W], alpha [H,W], radii [N] int32).

    ``pixels`` ([P, 2] integer (x, y)) composites only those pixels of the
    full camera, returning image [P,C], depth [P] and alpha [P]: the
    oracle at a few pixels of a view too large for the whole."""
    C = colors.shape[-1]
    dev = means3d.device
    if bg is None:
        bg = torch.zeros((C,), dtype=torch.float32, device=dev)
    proj = project.project_gaussians(means3d, scales, quats, camera, cfg,
                                     alive=alive)
    order = binning.depth_sort(proj)
    xy = proj.xy[order]
    conic = proj.conic[order]
    dep = proj.depth[order]
    vis = proj.visible[order]
    op = opacities[order]
    col = colors[order]

    H, W = camera.height, camera.width
    if pixels is None:
        px = torch.arange(W, dtype=torch.float32, device=dev)[None, :].expand(
            H, W).reshape(-1)
        py = torch.arange(H, dtype=torch.float32, device=dev)[:, None].expand(
            H, W).reshape(-1)
    else:
        pixels = torch.as_tensor(pixels, device=dev)
        px, py = pixels[:, 0].to(torch.float32), pixels[:, 1].to(torch.float32)

    dx = xy[:, 0:1] - px[None, :]      # [N,P]
    dy = xy[:, 1:2] - py[None, :]
    a, b, c = conic[:, 0:1], conic[:, 1:2], conic[:, 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = torch.clamp(op[:, None] * torch.exp(power), max=cfg.alpha_max)

    # CUDA semantics: a Gaussian is blended only at pixels whose *tile* lies
    # inside its rect (it is never binned elsewhere), even where its alpha
    # passes alpha_min outside the 3-sigma box
    ts = float(cfg.tile_size)
    gx = -(-W // cfg.tile_size)
    gy = -(-H // cfg.tile_size)
    radius = proj.radius[order]
    # exclusive max = floor((u + r)/ts) + 1 (see pairs._tile_rects)
    rminx = torch.clamp(torch.floor((xy[:, 0] - radius) / ts), 0, gx)
    rmaxx = torch.clamp(torch.floor((xy[:, 0] + radius) / ts) + 1, 0, gx)
    rminy = torch.clamp(torch.floor((xy[:, 1] - radius) / ts), 0, gy)
    rmaxy = torch.clamp(torch.floor((xy[:, 1] + radius) / ts) + 1, 0, gy)
    ptx = torch.floor(px / ts)[None, :]
    pty = torch.floor(py / ts)[None, :]
    in_rect = ((rminx[:, None] <= ptx) & (ptx < rmaxx[:, None])
               & (rminy[:, None] <= pty) & (pty < rmaxy[:, None]))

    keep = (power <= 0.0) & (alpha >= cfg.alpha_min) & vis[:, None] & in_rect
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

    t_inc = torch.cumprod(1.0 - alpha, dim=0)
    t_exc = torch.cat([torch.ones_like(t_inc[:1]), t_inc[:-1]], dim=0)
    w = alpha * t_exc * (t_inc >= cfg.transmittance_eps).to(alpha.dtype)

    alpha_out = torch.sum(w, dim=0)
    img = w.T @ col + (1.0 - alpha_out)[:, None] * bg[None, :]
    depth = w.T @ dep
    if pixels is not None:
        return img, depth, alpha_out, proj.radius.to(torch.int32)
    return (img.reshape(H, W, C), depth.reshape(H, W),
            alpha_out.reshape(H, W), proj.radius.to(torch.int32))
