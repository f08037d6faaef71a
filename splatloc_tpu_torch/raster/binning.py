"""Depth sort + per-tile Gaussian index lists.

Port of ``splatloc_tpu.raster.binning``: the Gaussian axis is sorted by
view depth once, then each tile gets a fixed-capacity, depth-ordered index
list by a cumsum + scatter compaction (no dynamic shapes, no atomics), so a
tile's order is the reference CUDA rasterizer's (tile|depth) key order.
The lists feed the tiled blend (``raster/blend.py``).
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.raster.types import Projected, RasterConfig


def depth_sort(proj: Projected) -> torch.Tensor:
    """Permutation [N] sorting visible Gaussians front-to-back; invisible
    Gaussians sort to the end. Stable, as ``jnp.argsort`` is: the invisible
    ones all tie at +inf and keep their index order."""
    key = torch.where(proj.visible, proj.depth,
                      torch.full_like(proj.depth, float("inf")))
    return torch.argsort(key, stable=True)


def tile_lists(proj: Projected, order: torch.Tensor, width: int, height: int,
               cfg: RasterConfig):
    """Per-tile index lists into the *sorted* axis.

    Returns (lists [T, K] int32, counts [T] int32, n_dropped [] int32: the
    entries lost to the per-tile capacity K = cfg.max_per_tile). Entries
    past a tile's count are N (an out-of-range sentinel). T = tiles_y *
    tiles_x, row-major. A tile past capacity keeps its closest K. Tiles are
    processed ``cfg.tile_chunk`` at a time, bounding the [chunk, N] masks.
    """
    ts = cfg.tile_size
    gx = -(-width // ts)
    gy = -(-height // ts)
    T = gx * gy
    K = cfg.max_per_tile
    N = proj.u.shape[0]
    dev = proj.u.device

    # sorted per-Gaussian tile rects; exclusive max = floor((u + r)/ts) + 1
    u, v = proj.u[order], proj.v[order]
    radius = proj.radius[order]
    visible = proj.visible[order]
    tsf = float(ts)

    def tile_edge(x, hi):
        return torch.clamp(x, 0, hi).to(torch.int32)
    rminx = tile_edge(torch.floor((u - radius) / tsf), gx)
    rmaxx = tile_edge(torch.floor((u + radius) / tsf) + 1, gx)
    rminy = tile_edge(torch.floor((v - radius) / tsf), gy)
    rmaxy = tile_edge(torch.floor((v + radius) / tsf) + 1, gy)

    tile_ids = torch.arange(T, dtype=torch.int32, device=dev)
    tx, ty = tile_ids % gx, tile_ids // gx
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    chunk = max(cfg.tile_chunk, 1)
    lists, counts, dropped = [], [], []
    for c0 in range(0, T, chunk):
        txc, tyc = tx[c0:c0 + chunk, None], ty[c0:c0 + chunk, None]
        mask = (visible[None] & (rminx[None] <= txc) & (txc < rmaxx[None])
                & (rminy[None] <= tyc) & (tyc < rmaxy[None]))       # [c, N]
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
        raw = torch.sum(mask, dim=1, dtype=torch.int32)
        # an entry past capacity (or outside the tile) writes to the spare
        # slot K, which is dropped
        dst = torch.where(mask & (pos < K), pos, K).long()
        lst = torch.full((mask.shape[0], K + 1), N, dtype=torch.int32,
                         device=dev)
        lst.scatter_(1, dst, ids.expand(mask.shape[0], N))
        lists.append(lst[:, :K])
        counts.append(torch.clamp(raw, max=K))
        dropped.append(torch.clamp(raw - K, min=0))
    return (torch.cat(lists), torch.cat(counts),
            torch.sum(torch.cat(dropped)).to(torch.int32))
