"""(Gaussian, tile) pair construction: the CUDA duplicate+sort binning with
128-aligned per-tile segments.

Port of ``splatloc_tpu.raster.pairs``; every integer output is bit-identical
to the JAX package's. Each visible Gaussian emits the tiles its rect covers
as keys ``tile_id << IDX_BITS | depth_rank``; per-tile pair counts come
before the sort from a corner-difference histogram over the tile grid, and
``(-count) % 128`` filler keys per tile make every tile segment start
128-aligned after one sort. Filler and overflow entries carry index N,
whose attributes are all zero, so they are inert in the blend.

All integer tensors are int32, as in the JAX package (torch's default
int64 is cast away at every ``arange``, ``cumsum`` and ``sum``).
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.raster.types import RasterConfig

IDX_BITS = 20
IDX_MASK = (1 << IDX_BITS) - 1      # filler rank sentinel; needs N < IDX_MASK
ALIGN = 128
_I32_MAX = np.iinfo(np.int32).max
_I32 = torch.int32


def _components(xy, radius_xy):
    """(u, v, rx, ry) 1-D vectors from [N, 2] tensors or (u, v) / (rx, ry)
    tuples."""
    if isinstance(xy, tuple):
        u, v = xy
    else:
        u, v = xy[:, 0], xy[:, 1]
    if isinstance(radius_xy, tuple):
        rx, ry = radius_xy
    else:
        rx, ry = radius_xy[:, 0], radius_xy[:, 1]
    return u, v, rx, ry


def _n_of(xy) -> int:
    return (xy[0] if isinstance(xy, tuple) else xy).shape[0]


def _tile_rects(xy, radius_xy, width, height, ts):
    """Per-Gaussian touched-tile rectangle, clipped to the tile grid; the
    exclusive max is floor((u + r)/ts) + 1, the last tile with any pixel
    center <= u + r."""
    gx = -(-width // ts)
    gy = -(-height // ts)
    u, v, rx, ry = _components(xy, radius_xy)
    tsf = float(ts)
    rminx = torch.clamp(torch.floor((u - rx) / tsf), 0, gx).to(_I32)
    rmaxx = torch.clamp(torch.floor((u + rx) / tsf) + 1, 0, gx).to(_I32)
    rminy = torch.clamp(torch.floor((v - ry) / tsf), 0, gy).to(_I32)
    rmaxy = torch.clamp(torch.floor((v + ry) / tsf) + 1, 0, gy).to(_I32)
    return rminx, rmaxx, rminy, rmaxy


def resolve_caps(cfg: RasterConfig, n: int,
                 max_tiles: int | None = None,
                 pair_cap: int | None = None) -> tuple[int, int]:
    if max_tiles is None:
        max_tiles = cfg.max_tiles
    if pair_cap is None:
        pair_cap = (cfg.pair_cap_override if cfg.pair_cap_override
                    else cfg.pair_cap_factor * n)
    pair_cap = int(np.ceil(pair_cap / ALIGN)) * ALIGN
    return max_tiles, pair_cap


def _misaligned(cap_al: int) -> int:
    """Keep the pair-array length off 1024-multiples (a TPU gather-emitter
    quirk of the JAX package; kept so both packages size the pair array
    identically). 640 keeps 128-alignment."""
    return cap_al + 640 if cap_al % 1024 == 0 else cap_al


def _cap_al(cfg: RasterConfig, n: int, width: int, height: int,
            pair_cap: int, max_tiles: int) -> int:
    """Static aligned pair-array length: budget + per-tile fill reserve,
    nudged off 1024-multiples, clamped to the total key population."""
    ts = cfg.tile_size
    T = (-(-width // ts)) * (-(-height // ts))
    total = (n * max_tiles
             + sum(k * c for k, c in extension_tiers(cfg, n, width, height))
             + T * ALIGN)
    return min(_misaligned(pair_cap + T * ALIGN), (total // ALIGN) * ALIGN)


def _bisect(sorted_arr: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Vector lower bound: first index i with sorted_arr[i] >= query."""
    return torch.searchsorted(sorted_arr, queries, right=False).to(_I32)


def aligned_cap(cfg: RasterConfig, n: int, width: int, height: int) -> int:
    """Static size of the aligned pair array."""
    max_tiles, pair_cap = resolve_caps(cfg, n)
    return _cap_al(cfg, n, width, height, pair_cap, max_tiles)


def _emission(xy, radius_xy, visible, width, height, ts, max_tiles):
    """Each visible Gaussian emits the first ``m`` row-major cells of its
    rect: the full rect when it fits ``max_tiles``, else max_tiles rounded
    down to whole rows."""
    rminx, rmaxx, rminy, rmaxy = _tile_rects(xy, radius_xy, width, height,
                                             ts)
    aw = rmaxx - rminx
    ah = rmaxy - rminy
    area = aw * ah
    awc = torch.clamp(aw, min=1)
    m = torch.where(area <= max_tiles, area,
                    (max_tiles // awc) * awc)
    m = torch.where(visible, m, torch.zeros_like(m))
    n_trunc = torch.sum(torch.clamp(area - m, min=0) * visible.to(_I32),
                        dtype=_I32)
    return rminx, rminy, aw, awc, m, area, n_trunc


def big_tiles_for(cfg: RasterConfig, width: int, height: int) -> int:
    """Max tiles any one Gaussian can emit (the max run length of one depth
    rank in the sorted pair array)."""
    caps = [cap for _, cap in extension_tiers(cfg, 1 << 20, width, height)]
    return max(caps, default=cfg.max_tiles)


def _corner_blocks(rminx, rminy, aw, awc, m, G, gxp, flip,
                   partial: bool = True):
    """Corner-id arrays encoding the emission of the first ``m`` row-major
    cells of each rect (<= 8 signed corners on the (gy+1, gx+1) difference
    grid). Minus-corners are tagged +G; ``flip`` swaps plus and minus;
    ``partial=False`` emits only the 4 full-rows corners (the caller's
    ``m`` is row-rounded)."""
    sent = torch.full_like(m, 2 * G)
    q = torch.div(m, awc, rounding_mode="floor")
    r = m - q * awc

    def cid(y, x):
        return y * gxp + x

    a1 = q > 0
    a2 = r > 0
    y1 = rminy + q
    plus = [torch.where(a1, cid(rminy, rminx), sent),
            torch.where(a1, cid(y1, rminx + aw), sent)]
    minus = [torch.where(a1, cid(rminy, rminx + aw), sent),
             torch.where(a1, cid(y1, rminx), sent)]
    if partial:
        plus += [torch.where(a2, cid(y1, rminx), sent),
                 torch.where(a2, cid(y1 + 1, rminx + r), sent)]
        minus += [torch.where(a2, cid(y1, rminx + r), sent),
                  torch.where(a2, cid(y1 + 1, rminx), sent)]
    if flip:
        plus, minus = minus, plus
    return plus + [x + G for x in minus]


def _tile_counts(corner_ids, gx, gy):
    """Exact per-tile emitted-pair counts [gy*gx] without the main sort:
    sort the corner ids, bisect per-id occurrence counts, difference the
    plus/minus planes, 2-D prefix sum."""
    gxp = gx + 1
    G = gxp * (gy + 1)
    ids = torch.cat(corner_ids)
    s = torch.sort(ids).values
    bounds = _bisect(s, torch.arange(2 * G + 1, dtype=_I32,
                                     device=ids.device))
    per_id = bounds[1:] - bounds[:-1]                        # [2G]
    diff = (per_id[:G] - per_id[G:]).reshape(gy + 1, gxp)
    counts2d = torch.cumsum(torch.cumsum(diff, dim=0, dtype=_I32), dim=1,
                            dtype=_I32)
    return counts2d[:gy, :gx].reshape(-1)                    # [T]


def extension_tiers(cfg: RasterConfig, n: int,
                    width: int, height: int) -> list[tuple[int, int]]:
    """Static (count, tile cap) tiers of the giant-splat extension."""
    ts = cfg.tile_size
    T = (-(-width // ts)) * (-(-height // ts))
    full = T if cfg.big_tiles is None else min(cfg.big_tiles, T)
    tiers = []
    ka = min(cfg.big_k, n)
    if ka > 0 and full > cfg.max_tiles:
        tiers.append((ka, full))
    kb = min(cfg.mid_k, max(n - ka, 0))
    mid = min(cfg.mid_tiles, full)
    if kb > 0 and cfg.max_tiles < mid < full:
        tiers.append((kb, mid))
    return tiers


def _big_extension(area, visible, rminx, rminy, aw, awc, m,
                   gx, G, gxp, tiers):
    """Giant-splat extension: the largest-area visible Gaussians (one
    stable descending area sort) emit their remaining cells
    [m, min(area, cap)) beyond the dense cap, tier by tier. Returns (corner
    id blocks, total per-Gaussian extension [N], per-tier key geometry)."""
    areav = torch.where(visible, area, torch.zeros_like(area))
    order_desc = torch.sort(-areav, stable=True).indices.to(_I32)
    ids, geo = [], []
    m_ext = torch.zeros_like(m)
    off = 0
    for K, cap in tiers:
        bidx = order_desc[off:off + K]
        off += K
        bl = bidx.long()
        m2 = torch.clamp(torch.clamp(areav[bl], max=cap), max=IDX_MASK)
        m1 = m[bl]                               # dense part already emitted
        ext = torch.clamp(m2 - m1, min=0)
        brminx, brminy = rminx[bl], rminy[bl]
        baw, bawc = aw[bl], awc[bl]
        ids += (_corner_blocks(brminx, brminy, baw, bawc, m2, G, gxp, False)
                + _corner_blocks(brminx, brminy, baw, bawc, m1, G, gxp,
                                 True, partial=False))
        m_ext = m_ext.index_add(0, bl, ext)      # bidx is unique
        geo.append((bidx, brminx, brminy, bawc, m1, m2, cap))
    return ids, m_ext, geo


def _counts_and_geometry(xy, radius_xy, visible, width, height, cfg,
                         max_tiles):
    """Shared between pair_stats and build_pairs: emission geometry, exact
    per-tile counts (dense + extension tiers), per-rank totals and the
    truncation remaining after the extension."""
    ts = cfg.tile_size
    gx = -(-width // ts)
    gy = -(-height // ts)
    gxp = gx + 1
    G = gxp * (gy + 1)
    N = _n_of(xy)
    rminx, rminy, aw, awc, m, area, n_trunc = _emission(
        xy, radius_xy, visible, width, height, ts, max_tiles)
    ids = _corner_blocks(rminx, rminy, aw, awc, m, G, gxp, False,
                         partial=False)
    tiers = extension_tiers(cfg, N, width, height)
    geo = []
    m_tot = m
    if tiers:
        bids, m_ext, geo = _big_extension(
            area, visible, rminx, rminy, aw, awc, m, gx, G, gxp, tiers)
        ids = ids + bids
        m_tot = m + m_ext
        n_trunc = n_trunc - torch.sum(m_ext, dtype=_I32)
    counts = _tile_counts(ids, gx, gy)
    return (gx, gy, rminx, rminy, awc, m, m_tot, counts, n_trunc, geo)


def _aligned_starts(counts):
    asize = torch.div(counts + ALIGN - 1, ALIGN,
                      rounding_mode="floor") * ALIGN
    return torch.cat([torch.zeros((1,), dtype=_I32, device=counts.device),
                      torch.cumsum(asize, dim=0, dtype=_I32)])[:-1]


def pair_stats(xy, radius_xy, visible, width: int, height: int,
               cfg: RasterConfig):
    """Exact (n_pairs_kept, n_dropped, n_trunc) of build_pairs without the
    main sort."""
    N = _n_of(xy)
    max_tiles, pair_cap = resolve_caps(cfg, N)
    geo = _counts_and_geometry(xy, radius_xy, visible, width, height, cfg,
                               max_tiles)
    m_tot, counts, n_trunc = geo[6], geo[7], geo[8]
    cap_al = _cap_al(cfg, N, width, height, pair_cap, max_tiles)
    astarts = _aligned_starts(counts)
    kept = torch.sum(torch.minimum(torch.clamp(cap_al - astarts, min=0),
                                   counts), dtype=_I32)
    total_valid = torch.sum(m_tot, dtype=_I32)
    return kept, n_trunc + (total_valid - kept), n_trunc


def pair_need(xy, radius_xy, visible, width: int, height: int,
              cfg: RasterConfig):
    """Exact 128-aligned pair-array length this scene needs under ``cfg``
    with no drops (the probe behind ``RasterConfig.pair_cap_override``)."""
    N = _n_of(xy)
    max_tiles, _ = resolve_caps(cfg, N)
    geo = _counts_and_geometry(xy, radius_xy, visible, width, height,
                               cfg, max_tiles)
    counts = geo[7]
    asize = torch.div(counts + ALIGN - 1, ALIGN,
                      rounding_mode="floor") * ALIGN
    return torch.sum(asize, dtype=_I32)


def build_pairs(xy, radius_xy, visible, width: int, height: int,
                cfg: RasterConfig, max_tiles: int | None = None,
                pair_cap: int | None = None):
    """Inputs are depth-sorted per-Gaussian screen quantities.

    Returns dict with:
      pair_idx [CAP_AL] int32 depth rank (index into the depth-sorted
                        Gaussian axis), in per-tile segments each starting
                        128-aligned (N = padding sentinel)
      starts   [T]      int32 aligned segment start (start % 128 == 0)
      counts   [T]      int32 valid pair count per tile (clamped at the cap)
      per_rank_counts [N] int32 emitted pairs per depth rank
      n_dropped         int32 pairs lost to max_tiles truncation or pair_cap
      n_trunc           int32 the subset lost to the per-Gaussian tile cap
    """
    ts = cfg.tile_size
    gx = -(-width // ts)
    gy = -(-height // ts)
    T = gx * gy
    N = _n_of(xy)
    if not N < IDX_MASK:
        raise ValueError(f"{N} Gaussians exceed the {IDX_BITS}-bit rank")
    if not T < (1 << (31 - IDX_BITS)):
        raise ValueError(f"{T} tiles exceed the key's tile bits")
    max_tiles, pair_cap = resolve_caps(cfg, N, max_tiles, pair_cap)
    cap_al = _cap_al(cfg, N, width, height, pair_cap, max_tiles)
    dev = visible.device

    (gx, gy, rminx, rminy, awc, m, m_tot, counts, n_trunc,
     geo) = _counts_and_geometry(xy, radius_xy, visible, width, height,
                                 cfg, max_tiles)

    # per-tile filler population so every segment is a 128-multiple
    fill = torch.remainder(-counts, ALIGN)
    astarts = _aligned_starts(counts)
    i32_max = torch.full((), _I32_MAX, dtype=_I32, device=dev)

    # slot-major [MT, N] emission table; the sort consumes a multiset
    slot = torch.arange(max_tiles, dtype=_I32, device=dev)[:, None]
    dx = torch.remainder(slot, awc[None, :])
    dy = torch.div(slot, awc[None, :], rounding_mode="floor")
    tile = (rminy[None, :] + dy) * gx + rminx[None, :] + dx      # [MT, N]
    ridx = torch.arange(N, dtype=_I32, device=dev)
    key = torch.where(slot < m[None, :],
                      (tile << IDX_BITS) | ridx[None, :], i32_max)
    key_blocks = [key.reshape(-1)]

    for bidx, brminx, brminy, bawc, m1, m2, cap in geo:
        # giant-splat extension keys: cells [m1, m2) of this tier's rects
        slot2 = torch.arange(cap, dtype=_I32, device=dev)[:, None]
        dx2 = torch.remainder(slot2, bawc[None, :])
        dy2 = torch.div(slot2, bawc[None, :], rounding_mode="floor")
        ok2 = (slot2 >= m1[None, :]) & (slot2 < m2[None, :])
        # the masked-out branch is clamped: dy2 can run past the rect and
        # the tile id would overflow the shift
        tile2 = torch.where(ok2, (brminy[None, :] + dy2) * gx
                            + brminx[None, :] + dx2, torch.zeros_like(dy2))
        key_blocks.append(torch.where(
            ok2, (tile2 << IDX_BITS) | bidx[None, :], i32_max).reshape(-1))

    lane = torch.arange(ALIGN, dtype=_I32, device=dev)
    tid = torch.arange(T, dtype=_I32, device=dev)
    fkey = torch.where(lane[None, :] < fill[:, None],
                       (tid[:, None] << IDX_BITS) | IDX_MASK, i32_max)
    key_blocks.append(fkey.reshape(-1))

    # keys are unique apart from identical sentinels, so an unstable sort
    # gives the same array as the JAX package's
    sorted_all = torch.sort(torch.cat(key_blocks)).values[:cap_al]
    rank = sorted_all & IDX_MASK
    pair_idx = torch.where(rank == IDX_MASK,
                           torch.full_like(rank, N), rank)

    counts_c = torch.minimum(torch.clamp(cap_al - astarts, min=0), counts)
    total_valid = torch.sum(m_tot, dtype=_I32)
    n_dropped = n_trunc + (total_valid - torch.sum(counts_c, dtype=_I32))
    return {"pair_idx": pair_idx.to(_I32),
            "starts": torch.clamp(astarts, max=cap_al), "counts": counts_c,
            "per_rank_counts": m_tot, "n_dropped": n_dropped,
            "n_trunc": n_trunc}
