"""Per-tile front-to-back alpha compositing (the tiled blend).

Port of ``splatloc_tpu.raster.blend``, the ``use_pallas=False`` path. With
alphas in depth order, transmittance is an exclusive cumulative product and
the blend weights w_i = alpha_i * T_i turn compositing into one matrix
product ``[pixels, K] @ [K, channels]`` per tile. The clamps and the early
termination are the CUDA forward's:

    alpha   = min(alpha_max, opa * exp(power)),   zeroed if < alpha_min or power > 0
    T_inc   = cumprod(1 - alpha)                  (monotone non-increasing)
    live    = T_inc >= transmittance_eps          (CUDA: test_T < eps => done)
    w       = alpha * T_exc * live

Gradients come from autograd of this program. Each chunk of tiles is
recomputed in the backward pass (``torch.utils.checkpoint``, the JAX
package's ``jax.checkpoint(nothing_saveable)``), so the [K, P] matrices of
every tile are never held at once.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from splatloc_tpu_torch.raster.types import RasterConfig


def blend_tile(tile_origin, xy, conic, opacity, colors, depth, valid,
               cfg: RasterConfig):
    """Composite tiles: tile_origin [..., 2] (x0, y0) pixel coords of each
    tile's corner; xy [..., K, 2], conic [..., K, 3], opacity [..., K],
    colors [..., K, C], depth [..., K], valid [..., K] bool. Returns
    (rgbc [..., P, C], depth [..., P], alpha [..., P]) with P = tile_size**2
    pixels in row-major order."""
    ts = cfg.tile_size
    grid = torch.arange(ts, dtype=torch.float32, device=xy.device)
    py = grid[:, None].expand(ts, ts).reshape(-1)
    px = grid[None, :].expand(ts, ts).reshape(-1)
    pix_x = tile_origin[..., 0:1] + px                   # [..., P]
    pix_y = tile_origin[..., 1:2] + py

    dx = xy[..., 0:1] - pix_x[..., None, :]              # [..., K, P]
    dy = xy[..., 1:2] - pix_y[..., None, :]
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy

    alpha = opacity[..., None] * torch.exp(power)
    alpha = torch.clamp(alpha, max=cfg.alpha_max)
    keep = (power <= 0.0) & (alpha >= cfg.alpha_min) & valid[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))

    t_inc = torch.cumprod(1.0 - alpha, dim=-2)           # [..., K, P]
    t_exc = torch.cat([torch.ones_like(t_inc[..., :1, :]),
                       t_inc[..., :-1, :]], dim=-2)
    live = t_inc >= cfg.transmittance_eps
    w = alpha * t_exc * live.to(alpha.dtype)             # [..., K, P]

    wt = w.transpose(-1, -2)                             # [..., P, K]
    out_c = torch.matmul(wt, colors)                     # [..., P, C]
    out_d = torch.matmul(wt, depth[..., None])[..., 0]
    out_a = torch.sum(w, dim=-2)
    return out_c, out_d, out_a


def blend_image(lists, sorted_xy, sorted_conic, sorted_opacity,
                sorted_colors, sorted_depth, width: int, height: int,
                cfg: RasterConfig, bg):
    """Blend all tiles and assemble the image. ``lists`` [T, K] indexes the
    depth-sorted arrays (N is the out-of-range sentinel; binning.tile_lists).

    Returns (image [H,W,C], depth [H,W], alpha [H,W])."""
    ts = cfg.tile_size
    gx = -(-width // ts)
    gy = -(-height // ts)
    T = gx * gy
    N = sorted_xy.shape[0]
    C = sorted_colors.shape[-1]
    dev = sorted_xy.device

    tile_ids = torch.arange(T, device=dev)
    origins = torch.stack([(tile_ids % gx) * ts, (tile_ids // gx) * ts],
                          dim=-1).to(torch.float32)

    # one zero row past the end makes index N an always-invalid gather
    def pad1(x):
        return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    padded = [pad1(x) for x in (sorted_xy, sorted_conic, sorted_opacity,
                                sorted_colors, sorted_depth)]

    def chunk_tiles(origin, idx, p_xy, p_conic, p_op, p_col, p_dep):
        return blend_tile(origin, p_xy[idx], p_conic[idx], p_op[idx],
                          p_col[idx], p_dep[idx], idx < N, cfg)

    grad = torch.is_grad_enabled() and any(x.requires_grad for x in padded)
    chunk = max(cfg.tile_chunk, 1)
    outs = []
    for c0 in range(0, T, chunk):
        args = (origins[c0:c0 + chunk], lists[c0:c0 + chunk].long(), *padded)
        if grad:
            outs.append(checkpoint(chunk_tiles, *args, use_reentrant=False))
        else:
            outs.append(chunk_tiles(*args))
    out_c, out_d, out_a = (torch.cat(x) for x in zip(*outs))

    # background composite: C_final = C + T_final * bg, T_final = 1 - alpha
    out_c = out_c + (1.0 - out_a)[..., None] * bg[None, None, :]

    def assemble(x, channels):
        x = x.reshape(gy, gx, ts, ts, channels)
        x = x.permute(0, 2, 1, 3, 4).reshape(gy * ts, gx * ts, channels)
        return x[:height, :width]

    image = assemble(out_c, C)
    depth = assemble(out_d[..., None], 1)[..., 0]
    alpha = assemble(out_a[..., None], 1)[..., 0]
    return image, depth, alpha
