"""Pair-walk rasterization core for Hopper: the differentiable blend over
sort-binned (Gaussian, tile) pairs, forward and backward.

Counterpart of ``splatloc_tpu.raster.pallas_raster``. Per tile, the forward
walk composites the tile's contiguous, 128-aligned segment of the
depth-sorted per-pair attribute table front to back; the backward walk goes
back to front from the tile's last contributing chunk, rebuilding the
transmittance by division over blended pairs, and writes one row of
per-pair gradients for every pair of the segment. Alignment padding pairs
carry Gaussian index K, whose attributes are all zero, so they are inert.
Because segments are 128-aligned, every row of the gradient slab has one
owning tile; a segmented reduction over depth-rank runs then turns per-pair
rows into per-Gaussian gradients. Nothing uses float atomics, so a step is
deterministic.

Kernels (sources under ``csrc/``), each beside its plain PyTorch version,
which is the CPU path and the oracle the kernel is held against on the card:

- ``fwd_pairwalk`` / ``fwd_pairwalk_plain``: ``csrc/fwd_pairwalk.cu``,
  replacing ``_fwd_kernel``;
- ``bwd_pairwalk`` / ``bwd_pairwalk_plain``: ``csrc/bwd_pairwalk.cu``,
  replacing ``_bwd_kernel``;
- ``seg_reduce`` / ``seg_reduce_plain``: ``csrc/seg_reduce.cu``, replacing
  the rank sort, ``_segscan_kernel`` with its run-end read, and
  ``_compact_copy_kernel``, whose upcast of the slab to float32 is the
  kernel's load (its other half, pinning the TPU's compact layout, has no
  meaning on Hopper).

``blend_pairs`` is a ``torch.autograd.Function`` whose backward is the
backward walk and the reduction.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from splatloc_tpu_torch import build
from splatloc_tpu_torch.raster import pairs as pairs_mod
from splatloc_tpu_torch.raster.types import RasterConfig

# attribute-major row layout of per-pair data
R_X, R_Y, R_CA, R_CB, R_CC, R_OP, R_DEPTH = 0, 1, 2, 3, 4, 5, 6
N_FIXED = 7
# pairs per step of the plain version (= the segment alignment)
CHUNK = 128
# tiles per step of the plain version
PLAIN_TILE_BATCH = 64
# floor of the per-pair keep epsilon of the power <= 0 test
_POWER_KEEP_EPS = 1e-5
# most channels the kernel takes (its accumulators live in registers)
MAX_CHANNELS = 24
# tile sizes the CUDA walks take: whole warps of threads that each take one
# or two horizontally adjacent pixels (csrc/*_pairwalk.cu), at most 512
# threads a block
CUDA_TILE_SIZES = (8, 16, 24, 32)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a fused multiply-add; the product
    of two float32 values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _rows_for(c: int) -> int:
    # + 3: the binning rect rows (radius_x, radius_y, visible) ride in the
    # table (see _build_per_g)
    need = N_FIXED + c + 3
    if need <= 8:
        return 8
    return 16 if need <= 16 else 32


def _rect_rows(c: int) -> tuple[int, int, int]:
    """(radius_x, radius_y, visible) row indices in the per-Gaussian
    table for C = c channels."""
    return N_FIXED + c, N_FIXED + c + 1, N_FIXED + c + 2


def _origins(width, height, ts):
    """(T, [2T] int32 pixel origins (x0, y0) of the row-major tiles)."""
    gx = -(-width // ts)
    gy = -(-height // ts)
    T = gx * gy
    tile_ids = np.arange(T, dtype=np.int32)
    return T, np.stack([(tile_ids % gx) * ts, (tile_ids // gx) * ts],
                       -1).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _origins_on(width, height, ts, device) -> torch.Tensor:
    """The [2T] int32 tile origins of ``_origins``, made on ``device`` once:
    a copy from the host waits for the stream."""
    gx = -(-width // ts)
    tile_ids = torch.arange(gx * -(-height // ts), dtype=torch.int32,
                            device=device)
    return torch.stack([(tile_ids % gx) * ts, (tile_ids // gx) * ts],
                       -1).reshape(-1)


def _build_per_g(xy, conic, opacity, depth, colors, order,
                 radius_xy=None, visible_f=None):
    """Depth-sorted per-Gaussian attribute table [rows, K+1] for the K
    Gaussians of ``order`` (no sentinel entry): column j is Gaussian
    order[j], and column K is all zeros, the inert padding sentinel that
    pair index K selects. The binning rect quantities (radius_xy, visible)
    ride in three of the table's padding rows (``_rect_rows``)."""
    c = colors.shape[-1]
    rows = _rows_for(c)
    us, vs = xy if isinstance(xy, tuple) else (xy[:, 0], xy[:, 1])
    ca, cb, cc = (conic if isinstance(conic, tuple)
                  else (conic[:, 0], conic[:, 1], conic[:, 2]))
    chans = [us, vs, ca, cb, cc, opacity, depth]   # R_X..R_DEPTH order
    chans += [colors[:, i] for i in range(c)]      # N_FIXED..
    if radius_xy is not None:
        rx, ry = (radius_xy if isinstance(radius_xy, tuple)
                  else (radius_xy[:, 0], radius_xy[:, 1]))
        chans += [rx, ry, visible_f]
    if len(chans) < rows:
        chans += [torch.zeros_like(us)] * (rows - len(chans))
    per_g = torch.stack(chans, dim=0)              # [rows, n]
    sorted_t = per_g.index_select(1, order)
    return torch.nn.functional.pad(sorted_t, (0, 1))   # [rows, K+1]


def _gather_pairs(per_g_sorted, rank_idx):
    """The pack gather: [rows, K+1] table -> [rows, PC] per-pair data."""
    return per_g_sorted.index_select(1, rank_idx.long())


def _pair_inputs(xy, conic, opacity, depth, colors, radius, visible, order,
                 width, height, cfg):
    """Everything the walk reads: (gpair [rows, PC], the build_pairs dict
    plus ``n_vis_dropped``, origins [2T] int32).

    All per-Gaussian inputs are unsorted; ``order`` is the depth
    permutation. cfg.visible_cap K (None = N) keeps the first K depth ranks
    before pair building (invisible Gaussians sort to the end); visible
    Gaussians beyond K are dropped and counted in ``n_vis_dropped``."""
    C = colors.shape[-1]
    n = (xy[0] if isinstance(xy, tuple) else xy).shape[0]

    K = n if cfg.visible_cap is None else min(int(cfg.visible_cap), n)
    n_vis = torch.sum(visible, dtype=torch.int32)
    n_vis_dropped = torch.clamp(n_vis - K, min=0)
    order = order[:K]

    per_gs = _build_per_g(xy, conic,
                          torch.where(visible, opacity,
                                      torch.zeros_like(opacity)),
                          depth, colors, order, radius_xy=radius,
                          visible_f=visible.to(torch.float32))
    rrx, rry, rvis = _rect_rows(C)
    pr = pairs_mod.build_pairs((per_gs[R_X, :K], per_gs[R_Y, :K]),
                               (per_gs[rrx, :K], per_gs[rry, :K]),
                               per_gs[rvis, :K] > 0.5, width, height, cfg)
    gpair = _gather_pairs(per_gs, torch.clamp(pr["pair_idx"], max=K))
    pr["n_vis_dropped"] = n_vis_dropped
    return gpair, pr, _origins_on(width, height, cfg.tile_size,
                                  gpair.device)


def _shard_rows(width, height, ts, D):
    """(rows_dev, H_local, Tl) of a tile grid whose rows are split over D
    ranks: each rank holds rows_dev = ceil(gy / D) tile rows, H_local
    pixels and Tl tiles; the grid is padded to D * rows_dev rows, whose
    phantom rows past the image are dropped."""
    gx = -(-width // ts)
    rows_dev = -(-(-(-height // ts)) // D)
    return rows_dev, rows_dev * ts, rows_dev * gx


def _pair_inputs(xy, conic, opacity, depth, colors, radius, visible, order,
                 width, height, cfg, mesh=None, axis="tile"):
    """Everything the walk reads: (gpair [rows, PC], the build_pairs dict
    plus ``n_vis_dropped``, origins [2T] int32).

    All per-Gaussian inputs are unsorted; ``order`` is the depth
    permutation. cfg.visible_cap K (None = N) keeps the first K depth ranks
    before pair building (invisible Gaussians sort to the end); visible
    Gaussians beyond K are dropped and counted in ``n_vis_dropped``.

    With ``mesh``, this rank bins pairs only for its own block of tile rows
    along ``axis`` (every rect shifted up by the block's first pixel row),
    under the per-rank pair budget ceil(pair_cap_factor * K *
    shard_pair_margin / D), and its tiles keep their pixel origins in the
    padded global grid; its drop counters are its own."""
    C = colors.shape[-1]
    n = (xy[0] if isinstance(xy, tuple) else xy).shape[0]

    K = n if cfg.visible_cap is None else min(int(cfg.visible_cap), n)
    n_vis = torch.sum(visible, dtype=torch.int32)
    n_vis_dropped = torch.clamp(n_vis - K, min=0)
    order = order[:K]

    per_gs = _build_per_g(xy, conic,
                          torch.where(visible, opacity,
                                      torch.zeros_like(opacity)),
                          depth, colors, order, radius_xy=radius,
                          visible_f=visible.to(torch.float32))
    rrx, rry, rvis = _rect_rows(C)
    rect_u, rect_v = per_gs[R_X, :K], per_gs[R_Y, :K]
    rect_r = (per_gs[rrx, :K], per_gs[rry, :K])
    rect_vis = per_gs[rvis, :K] > 0.5
    ts = cfg.tile_size
    if mesh is None:
        pr = pairs_mod.build_pairs((rect_u, rect_v), rect_r, rect_vis,
                                   width, height, cfg)
        origins = _origins_on(width, height, ts, per_gs.device)
    else:
        D, d = mesh.shape[axis], mesh.index(axis)
        _, H_local, Tl = _shard_rows(width, height, ts, D)
        pair_cap_local = int(np.ceil(cfg.pair_cap_factor * K
                                     * cfg.shard_pair_margin / D))
        pr = pairs_mod.build_pairs((rect_u, rect_v - float(d * H_local)),
                                   rect_r, rect_vis, width, H_local, cfg,
                                   pair_cap=pair_cap_local)
        origins = _origins_on(width, D * H_local, ts,
                              per_gs.device)[2 * d * Tl:2 * (d + 1) * Tl]
    gpair = _gather_pairs(per_gs, torch.clamp(pr["pair_idx"], max=K))
    pr["n_vis_dropped"] = n_vis_dropped
    return gpair, pr, origins


def _forward_impl(xy, conic, opacity, depth, colors, radius, visible, order,
                  width, height, cfg, mesh=None, axis="tile"):
    """(acc, the build_pairs dict, gpair, origins) of one render. acc is
    [T, C+4, P]; with ``mesh``, it is this rank's [Tl, C+4, P] block of
    tile rows (see _pair_inputs)."""
    gpair, pr, origins = _pair_inputs(xy, conic, opacity, depth, colors,
                                      radius, visible, order, width, height,
                                      cfg, mesh, axis)
    out = fwd_pairwalk(gpair, pr["starts"], pr["counts"], origins,
                       colors.shape[-1], cfg)
    return out, pr, gpair, origins


# --------------------------------------------------------------------------
# the forward pair walk: kernel wrapper and plain version
# --------------------------------------------------------------------------

def _pair_power(g, ox, oy, monos, ts):
    """(power [Tb, P, CH], keep_eps [Tb, CH]) of the pairs ``g`` [rows, Tb,
    CH] at every pixel of their tiles, whose origins are ``ox``/``oy``
    [Tb, 1]; ``monos`` are the [P] pixel monomials p, q, p^2, pq, q^2.

    The quadratic in tile-local coordinates is ill-conditioned for pairs far
    from the tile origin (|c0| reaches ~1e3 while power is O(1)), so its
    rounding moves T_blend by ~4e-5. It is therefore rounded as the JAX
    kernel rounds it on the CPU: the coefficients with that build's fused
    multiply-adds, and power as the sum of two limbs (the coefficients
    rounded to bf16, then their remainders), each a running sum of exact
    products, as the kernel's limb-split matrix product (``_dot_f32``)
    computes it. The CUDA kernel evaluates power the same way."""
    ex = g[R_X] - ox
    ey = g[R_Y] - oy
    ca, cb, cc = g[R_CA], g[R_CB], g[R_CC]
    b_ex = cb * ex
    c0 = -0.5 * _fma(ca * ex, ex, (cc * ey) * ey) - b_ex * ey
    c1 = _fma(ca, ex, cb * ey)
    c2 = _fma(cc, ey, b_ex)
    coefs = (c0, c1, c2, -0.5 * ca, -cb, -0.5 * cc)
    tm1 = float(ts - 1)
    mag = (torch.abs(c0) + tm1 * (torch.abs(c1) + torch.abs(c2))
           + tm1 * tm1 * (torch.abs(coefs[3]) + torch.abs(coefs[4])
                          + torch.abs(coefs[5])))
    keep_eps = torch.clamp(mag * (2.0 ** -14), min=_POWER_KEEP_EPS)
    hi = [c.to(torch.bfloat16).to(torch.float32) for c in coefs]
    limbs = []
    for limb in (hi, [c - h for c, h in zip(coefs, hi)]):
        s = limb[0][:, None, :]
        for cf, mono in zip(limb[1:], monos):
            s = s + cf[:, None, :] * mono[None, :, None]
        limbs.append(s)
    return limbs[0] + limbs[1], keep_eps


def fwd_pairwalk_plain(gpair, starts, counts, origins, n_channels: int,
                       cfg: RasterConfig):
    """The forward walk in plain PyTorch, vectorised over tiles and pixels,
    one chunk of CHUNK pairs per step, with the JAX kernel's math: power as
    in ``_pair_power``, and the in-chunk transmittance as exp of the
    exclusive cumulative sum of log1p(-alpha). Runs PLAIN_TILE_BATCH tiles
    at a time to bound memory ([PLAIN_TILE_BATCH, P, CHUNK] f32 per
    intermediate, 8 MB at 16x16 tiles).

    Returns [T, C+4, P]: C channels, depth, weight sum, n_contrib (absolute
    position of the last blended pair, -1 if none), T over blended pairs."""
    rows, PC = gpair.shape
    dev = gpair.device
    T = starts.shape[0]
    ts = cfg.tile_size
    P = ts * ts
    C = n_channels
    f32 = torch.float32
    flat = torch.arange(P, device=dev)
    p = (flat % ts).to(f32)
    q = (flat // ts).to(f32)
    monos = (p, q, p * p, p * q, q * q)                      # [P] each
    lane = torch.arange(CHUNK, device=dev)
    # prefix-exclusive triangular ones: su[r, c] = r < c
    su = (lane[:, None] < lane[None, :]).to(f32)
    origins2 = origins.reshape(T, 2).to(f32)
    out = torch.empty((T, C + 4, P), dtype=f32, device=dev)

    for b0 in range(0, T, PLAIN_TILE_BATCH):
        b1 = min(b0 + PLAIN_TILE_BATCH, T)
        st = starts[b0:b1].long()
        ct = counts[b0:b1].long()
        ox = origins2[b0:b1, 0:1]                            # [Tb, 1]
        oy = origins2[b0:b1, 1:2]
        nb = b1 - b0
        t_carry = torch.ones((nb, P), dtype=f32, device=dev)
        t_blend = torch.ones((nb, P), dtype=f32, device=dev)
        acc = torch.zeros((nb, C + 2, P), dtype=f32, device=dev)
        ncontrib = torch.full((nb, P), -1.0, dtype=f32, device=dev)
        nchunks = int(((ct + CHUNK - 1) // CHUNK).max().item()) if nb else 0
        for j in range(nchunks):
            off = j * CHUNK + lane                           # [CHUNK]
            valid = off[None, :] < ct[:, None]               # [Tb, CHUNK]
            col = torch.clamp(st[:, None] + off[None, :], max=PC - 1)
            g = gpair[:, col]                                # [rows, Tb, CH]
            op = g[R_OP]
            power, keep_eps = _pair_power(g, ox, oy, monos, ts)
            pm = torch.where(power <= keep_eps[:, None, :],
                             torch.clamp(power, max=0.0),
                             torch.full_like(power, -40.0))
            raw = op[:, None, :] * torch.exp(pm)
            alpha = torch.where(raw >= cfg.alpha_min,
                                torch.clamp(raw, max=cfg.alpha_max),
                                torch.zeros_like(raw))
            alpha = torch.where(valid[:, None, :], alpha,
                                torch.zeros_like(alpha))
            lg = torch.log1p(-alpha)
            cum = lg @ su                                    # prefix-excl
            t_exc = t_carry[:, :, None] * torch.exp(cum)
            aw = alpha * t_exc
            live = (t_exc - aw) >= cfg.transmittance_eps
            w = torch.where(live, aw, torch.zeros_like(aw))
            pos = (st[:, None] + off[None, :]).to(f32)       # [Tb, CH]
            ncontrib = torch.maximum(ncontrib, torch.amax(
                torch.where(w > 0.0, pos[:, None, :].expand_as(w),
                            torch.full_like(w, -1.0)), dim=-1))
            attrs = torch.stack(
                [g[N_FIXED + c] for c in range(C)]
                + [g[R_DEPTH], torch.ones_like(op)], dim=1)  # [Tb, C+2, CH]
            acc = acc + attrs @ w.transpose(1, 2)            # [Tb, C+2, P]
            t_carry = t_carry * torch.exp(torch.sum(lg, dim=-1))
            t_blend = t_blend * torch.exp(torch.sum(
                torch.where(live, lg, torch.zeros_like(lg)), dim=-1))
        out[b0:b1, :C + 2] = acc
        out[b0:b1, C + 2] = ncontrib
        out[b0:b1, C + 3] = t_blend
    return out


def _check_inputs(gpair, starts, counts, origins, n_channels, cfg):
    dev = gpair.device
    if gpair.dtype != torch.float32 or gpair.dim() != 2:
        raise ValueError(f"gpair must be a 2-D float32 tensor, got "
                         f"{gpair.dtype} {tuple(gpair.shape)}")
    T = starts.shape[0]
    for name, x, shape in (("starts", starts, (T,)), ("counts", counts, (T,)),
                           ("origins", origins, (2 * T,))):
        if x.dtype != torch.int32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, gpair on {dev}")
    if gpair.shape[0] < N_FIXED + n_channels:
        raise ValueError(f"gpair has {gpair.shape[0]} rows, needs "
                         f"{N_FIXED + n_channels}")
    if not 1 <= n_channels <= MAX_CHANNELS:
        raise ValueError(f"{n_channels} channels; the kernel takes 1.."
                         f"{MAX_CHANNELS}")
    if cfg.tile_size * cfg.tile_size > 1024:
        raise ValueError(f"tile_size {cfg.tile_size}: one thread per pixel "
                         f"allows at most 32")


def _require_cuda(name, dev, tensors):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for tname, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def _check_walk_layout(gpair, cfg: RasterConfig):
    """What the CUDA walks take beyond the plain versions: gpair rows that
    start 16 bytes apart (their stages arrive by 16-byte copies), and one of
    CUDA_TILE_SIZES."""
    if gpair.shape[1] % 4 or gpair.data_ptr() % 16:
        raise ValueError(f"gpair [{gpair.shape[0]}, {gpair.shape[1]}] at "
                         f"{gpair.data_ptr():#x}: the CUDA walks need PC % 4 "
                         f"== 0 and a 16-byte aligned table")
    if cfg.tile_size not in CUDA_TILE_SIZES:
        raise ValueError(f"tile_size {cfg.tile_size}: the CUDA walks take "
                         f"whole warps of pixel pairs, at most 512 threads "
                         f"a block: tile sizes {CUDA_TILE_SIZES}")


_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
_INT_P = ctypes.POINTER(ctypes.c_int)


def _kernel_lib():
    lib = build.load("fwd_pairwalk")
    lib.fwd_pairwalk_launch.argtypes = _LAUNCH_ARGTYPES
    lib.fwd_pairwalk_launch.restype = ctypes.c_int
    lib.fwd_pairwalk_info.argtypes = [ctypes.c_int] * 2 + [_INT_P] * 3
    lib.fwd_pairwalk_info.restype = ctypes.c_int
    return lib


def _launch_info(name, call) -> dict:
    """Runs a kernel's ``*_info`` C function, ``call(threads, smem,
    blocks)`` on three int out-pointers, into a dict."""
    out = [ctypes.c_int(0) for _ in range(3)]
    err = call(*(ctypes.byref(x) for x in out))
    if err != 0:
        raise RuntimeError(f"{name} failed: CUDA error {err}")
    return dict(zip(("threads", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in out)))


def fwd_pairwalk_info(n_channels: int, cfg: RasterConfig) -> dict:
    """The kernel's launch shape on the current CUDA device: threads and
    dynamic shared memory per block, and the blocks that fit on one SM."""
    return _launch_info("fwd_pairwalk_info", functools.partial(
        _kernel_lib().fwd_pairwalk_info, n_channels, cfg.tile_size))


def fwd_pairwalk(gpair, starts, counts, origins, n_channels: int,
                 cfg: RasterConfig):
    """Forward pair walk -> [T, C+4, P] (see fwd_pairwalk_plain).

    On CUDA tensors it launches the kernel ``csrc/fwd_pairwalk.cu`` on the
    current stream and adds one to ``fwd_pairwalk.launches``; on CPU
    tensors it runs the plain version. Any other device, a wrong dtype or
    shape, or a non-contiguous tensor raises, and on CUDA so do a tile size
    outside CUDA_TILE_SIZES and a misaligned table (_check_walk_layout)."""
    dev = gpair.device
    _check_inputs(gpair, starts, counts, origins, n_channels, cfg)
    if dev.type == "cpu":
        return fwd_pairwalk_plain(gpair, starts, counts, origins, n_channels,
                                  cfg)
    _require_cuda("fwd_pairwalk", dev, {"gpair": gpair, "starts": starts,
                                        "counts": counts, "origins": origins})
    _check_walk_layout(gpair, cfg)
    launch = _kernel_lib().fwd_pairwalk_launch
    T = starts.shape[0]
    P = cfg.tile_size * cfg.tile_size
    out = torch.empty((T, n_channels + 4, P), dtype=torch.float32,
                      device=dev)
    if T == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = launch(gpair.data_ptr(), gpair.shape[1], starts.data_ptr(),
                     counts.data_ptr(), origins.data_ptr(), out.data_ptr(),
                     T, n_channels, cfg.tile_size, cfg.alpha_max,
                     cfg.alpha_min, cfg.transmittance_eps, stream)
    if err != 0:
        raise RuntimeError(f"fwd_pairwalk launch failed: CUDA error {err}")
    fwd_pairwalk.launches += 1
    return out


fwd_pairwalk.launches = 0


# --------------------------------------------------------------------------
# the backward pair walk: kernel wrapper and plain version
# --------------------------------------------------------------------------

# Dtype of the per-pair gradient slab the backward walk writes and the
# reduction reads, the two largest memory passes of the backward. bfloat16
# (the default, as in the JAX package) rounds each per-pair gradient to
# nearest even before the float32 reduction: within 1.5 % relative L2 of the
# float32-slab gradients. SPLATLOC_GRAD_SLAB=f32 keeps float32 slabs.
GRAD_SLAB_DTYPE = (torch.float32 if os.environ.get("SPLATLOC_GRAD_SLAB")
                   == "f32" else torch.bfloat16)


def _jhi(fwd_out, starts, counts, n_channels: int):
    """[T] int32 last chunk of each tile's segment that holds a blended
    pair (-1 if none), from the forward's n_contrib channel."""
    max_pos = torch.amax(fwd_out[:, n_channels + 2, :], dim=-1).to(
        torch.int32)
    lo_t = torch.div(starts, CHUNK, rounding_mode="floor") * CHUNK
    nchunks_t = torch.div(counts + CHUNK - 1, CHUNK, rounding_mode="floor")
    last = torch.minimum(torch.div(max_pos - lo_t, CHUNK,
                                   rounding_mode="floor"), nchunks_t - 1)
    return torch.where(max_pos < lo_t, torch.full_like(last, -1),
                       last).to(torch.int32)


def _zero_fill_mask(starts, counts, jhi, pc: int):
    """[PC] bool: the chunks of each tile's segment past its ``jhi``, which
    the walk zero-fills instead of walking."""
    lo = starts.long() + (jhi.long() + 1) * CHUNK
    hi = starts.long() + torch.div(counts.long() + CHUNK - 1, CHUNK,
                                   rounding_mode="floor") * CHUNK
    empty = lo >= hi
    lo = torch.where(empty, torch.full_like(lo, pc), lo)
    hi = torch.where(empty, torch.full_like(hi, pc), hi)
    delta = torch.zeros(pc + 1, dtype=torch.int64, device=starts.device)
    delta.index_add_(0, lo, torch.ones_like(lo))
    delta.index_add_(0, hi, -torch.ones_like(hi))
    return torch.cumsum(delta, 0)[:pc] > 0


def bwd_pairwalk_plain(gpair, starts, counts, origins, jhi, fwd_out, cot,
                       n_channels: int, cfg: RasterConfig,
                       slab_dtype=None):
    """The backward walk in plain PyTorch -> slab [PC, rows] of per-pair
    gradients in ``slab_dtype`` (default GRAD_SLAB_DTYPE), pair-major.

    Vectorised over tiles and pixels, one chunk of CHUNK pairs per step
    from each tile's ``jhi`` down to 0, with the JAX kernel's math: power and
    alpha as the forward evaluates them; blended = kept and at or before
    the pixel's n_contrib; the transmittance before each pair as
    t_final * exp(-suffix-inclusive sum of log1p(-alpha) over blended
    pairs); the later-pairs sum s of w * u by a suffix product with a
    triangular ones matrix. Per pair, summed over the tile's pixels: the
    grads of x, y, conic a, b, c (through the six power coefficients),
    opacity, depth and the C channels. Chunks past ``jhi`` are zero rows;
    the slab past the last tile's segment is left unwritten (its pair ids
    are the sentinel K, which the reduction discards)."""
    rows, PC = gpair.shape
    dev = gpair.device
    T = starts.shape[0]
    ts = cfg.tile_size
    P = ts * ts
    C = n_channels
    f32 = torch.float32
    slab = torch.empty((PC, rows), dtype=slab_dtype or GRAD_SLAB_DTYPE,
                       device=dev)
    flat = torch.arange(P, device=dev)
    p = (flat % ts).to(f32)
    q = (flat // ts).to(f32)
    monos = (p, q, p * p, p * q, q * q)
    mono_t = torch.stack((torch.ones_like(p),) + monos)      # [6, P]
    lane = torch.arange(CHUNK, device=dev)
    # suffix-inclusive triangular ones: sli[r, c] = r >= c
    sli = (lane[:, None] >= lane[None, :]).to(f32)
    origins2 = origins.reshape(T, 2).to(f32)

    for b0 in range(0, T, PLAIN_TILE_BATCH):
        b1 = min(b0 + PLAIN_TILE_BATCH, T)
        st = starts[b0:b1].long()
        jh = jhi[b0:b1].long()
        ox = origins2[b0:b1, 0:1]
        oy = origins2[b0:b1, 1:2]
        ncontrib = fwd_out[b0:b1, C + 2]                     # [Tb, P]
        t_end = fwd_out[b0:b1, C + 3].clone()
        s_end = torch.zeros_like(t_end)
        cot_b = cot[b0:b1]                                   # [Tb, C+2, P]
        jmax = int(jh.max().item()) if b1 > b0 else -1
        for j in range(jmax, -1, -1):
            act = jh >= j                                    # [Tb]
            off = j * CHUNK + lane
            col = torch.clamp(st[:, None] + off[None, :], max=PC - 1)
            g = gpair[:, col]                                # [rows, Tb, CH]
            op = g[R_OP]
            power, keep_eps = _pair_power(g, ox, oy, monos, ts)
            e = torch.exp(torch.where(power <= keep_eps[:, None, :],
                                      torch.clamp(power, max=0.0),
                                      torch.full_like(power, -40.0)))
            raw = op[:, None, :] * e
            keep = raw >= cfg.alpha_min
            alpha = torch.where(keep, torch.clamp(raw, max=cfg.alpha_max),
                                torch.zeros_like(raw))
            pos = (st[:, None] + off[None, :]).to(f32)       # [Tb, CH]
            b = (keep & (pos[:, None, :] <= ncontrib[:, :, None])
                 & act[:, None, None])
            lg_eff = torch.where(b, torch.log1p(-alpha),
                                 torch.zeros_like(alpha))
            t_exc = t_end[:, :, None] * torch.exp(-(lg_eff @ sli))
            attrs = torch.stack(
                [g[N_FIXED + c] for c in range(C)]
                + [g[R_DEPTH], torch.ones_like(op)], dim=1)  # [Tb, C+2, CH]
            u = cot_b.transpose(1, 2) @ attrs                # [Tb, P, CH]
            bw = b.to(f32)
            w = bw * alpha * t_exc
            wu = w * u
            # suffix-exclusive sum of w * u, plus the later chunks' carry
            s_in = s_end[:, :, None] - wu + wu @ sli
            dalpha = bw * (t_exc * u - s_in / (1.0 - alpha))
            not_clamped = (raw < cfg.alpha_max).to(f32)
            in_ellipse = (power <= 0.0).to(f32)
            dpower = dalpha * alpha * not_clamped * in_ellipse
            dop_pix = dalpha * e * not_clamped
            # the six power-coefficient grads, summed over pixels as the
            # JAX kernel's limb-split product does (dpower as its bf16 limb
            # plus the remainder; the monomials are exact small integers)
            dp_hi = dpower.to(torch.bfloat16).to(f32)
            d = mono_t @ dp_hi + mono_t @ (dpower - dp_hi)   # [Tb, 6, CH]
            ex = g[R_X] - ox
            ey = g[R_Y] - oy
            ca, cb, cc = g[R_CA], g[R_CB], g[R_CC]
            d0, d1, d2, d3, d4, d5 = d.unbind(1)
            upd = torch.zeros((b1 - b0, CHUNK, rows), dtype=f32, device=dev)
            upd[:, :, R_X] = d0 * (-ca * ex - cb * ey) + d1 * ca + d2 * cb
            upd[:, :, R_Y] = d0 * (-cc * ey - cb * ex) + d1 * cb + d2 * cc
            upd[:, :, R_CA] = d0 * (-0.5 * ex * ex) + d1 * ex - 0.5 * d3
            upd[:, :, R_CB] = d0 * (-ex * ey) + d1 * ey + d2 * ex - d4
            upd[:, :, R_CC] = d0 * (-0.5 * ey * ey) + d2 * ey - 0.5 * d5
            upd[:, :, R_OP] = dop_pix.sum(1)
            d_attrs = cot_b @ w                              # [Tb, C+2, CH]
            upd[:, :, R_DEPTH] = d_attrs[:, C]
            upd[:, :, N_FIXED:N_FIXED + C] = d_attrs[:, :C].transpose(1, 2)
            slab[col[act]] = upd[act].to(slab.dtype)
            t_end = t_end * torch.exp(-lg_eff.sum(-1))
            s_end = s_end + wu.sum(-1)
    slab[_zero_fill_mask(starts, counts, jhi, PC)] = 0
    return slab


def _check_bwd_inputs(gpair, starts, counts, origins, jhi, fwd_out, cot,
                      n_channels, cfg):
    _check_inputs(gpair, starts, counts, origins, n_channels, cfg)
    T = starts.shape[0]
    P = cfg.tile_size * cfg.tile_size
    if jhi.dtype != torch.int32 or tuple(jhi.shape) != (T,):
        raise ValueError(f"jhi must be int32 ({T},), got {jhi.dtype} "
                         f"{tuple(jhi.shape)}")
    for name, x, shape in (("fwd_out", fwd_out, (T, n_channels + 4, P)),
                           ("cot", cot, (T, n_channels + 2, P))):
        if x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
    for x in (jhi, fwd_out, cot):
        if x.device != gpair.device:
            raise ValueError(f"inputs on {x.device} and {gpair.device}")
    if gpair.shape[0] not in (8, 16, 32):
        raise ValueError(f"gpair has {gpair.shape[0]} rows; the table has "
                         f"8, 16 or 32")
    if P % 32:
        raise ValueError(f"tile_size {cfg.tile_size}: the backward walk "
                         f"needs whole warps of pixels")


_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
                 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_float,
                                         ctypes.c_void_p])


def _bwd_lib():
    lib = build.load("bwd_pairwalk")
    lib.bwd_pairwalk_launch.argtypes = _BWD_ARGTYPES
    lib.bwd_pairwalk_launch.restype = ctypes.c_int
    lib.bwd_pairwalk_info.argtypes = [ctypes.c_int] * 3 + [_INT_P] * 3
    lib.bwd_pairwalk_info.restype = ctypes.c_int
    return lib


def bwd_pairwalk_info(n_channels: int, cfg: RasterConfig,
                      slab_dtype=None) -> dict:
    """The backward kernel's launch shape on the current CUDA device, as
    ``fwd_pairwalk_info``."""
    bf16 = int((slab_dtype or GRAD_SLAB_DTYPE) == torch.bfloat16)
    return _launch_info("bwd_pairwalk_info", functools.partial(
        _bwd_lib().bwd_pairwalk_info, n_channels, cfg.tile_size, bf16))


def bwd_pairwalk(gpair, starts, counts, origins, jhi, fwd_out, cot,
                 n_channels: int, cfg: RasterConfig, slab_dtype=None):
    """Backward pair walk -> slab [PC, rows] (see bwd_pairwalk_plain).

    On CUDA tensors it launches ``csrc/bwd_pairwalk.cu`` on the current
    stream into a slab from ``torch.empty`` and adds one to
    ``bwd_pairwalk.launches``; on CPU tensors it runs the plain version.
    Any other device, a wrong dtype or shape, or a non-contiguous tensor
    raises, and on CUDA so do a tile size outside CUDA_TILE_SIZES and a
    misaligned table (_check_walk_layout)."""
    dtype = slab_dtype or GRAD_SLAB_DTYPE
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"slab dtype {dtype}: float32 or bfloat16")
    dev = gpair.device
    _check_bwd_inputs(gpair, starts, counts, origins, jhi, fwd_out, cot,
                      n_channels, cfg)
    if dev.type == "cpu":
        return bwd_pairwalk_plain(gpair, starts, counts, origins, jhi,
                                  fwd_out, cot, n_channels, cfg, dtype)
    _require_cuda("bwd_pairwalk", dev, {
        "gpair": gpair, "starts": starts, "counts": counts,
        "origins": origins, "jhi": jhi, "fwd_out": fwd_out, "cot": cot})
    _check_walk_layout(gpair, cfg)
    rows, PC = gpair.shape
    T = starts.shape[0]
    slab = torch.empty((PC, rows), dtype=dtype, device=dev)
    if T == 0:
        return slab
    lib = _bwd_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.bwd_pairwalk_launch(
            gpair.data_ptr(), PC, starts.data_ptr(), counts.data_ptr(),
            origins.data_ptr(), jhi.data_ptr(), fwd_out.data_ptr(),
            cot.data_ptr(), slab.data_ptr(), T, rows, n_channels,
            cfg.tile_size, int(dtype == torch.bfloat16), cfg.alpha_max,
            cfg.alpha_min, stream)
    if err != 0:
        raise RuntimeError(f"bwd_pairwalk launch failed: CUDA error {err}")
    bwd_pairwalk.launches += 1
    return slab


bwd_pairwalk.launches = 0


# --------------------------------------------------------------------------
# the per-Gaussian reduction: kernel wrapper and plain version
# --------------------------------------------------------------------------

def seg_reduce_plain(slab, pair_idx, per_rank_counts, kmax: int):
    """Per-rank sums of the slab rows, as the JAX package's reduction reads
    them: a stable sort of the pairs by id (``sort_key_val``), the rows
    gathered through its permutation and upcast to float32, an inclusive
    segmented scan over the runs of equal sorted ids (Hillis-Steele,
    log2(kmax) passes), and each rank r's run end read at
    ``at = clip(ends[r] - 1, 0, PC - 1)``, ``ends`` the cumulative
    ``per_rank_counts``: it is the rank's sum where the sorted id at ``at``
    is r, else zeros. -> [K, rows] float32, K = len(per_rank_counts)."""
    PC, rows = slab.shape
    K = per_rank_counts.shape[0]
    si, perm = torch.sort(pair_idx, stable=True)
    ends = torch.cumsum(per_rank_counts, 0, dtype=torch.int32)
    x = slab.index_select(0, perm).to(torch.float32).T      # [rows, PC]
    pos = torch.arange(PC, device=slab.device)
    k = 1
    while k < kmax:
        same = (torch.roll(si, k) == si) & (pos >= k)
        x = torch.where(same[None, :], x + torch.roll(x, k, dims=1), x)
        k *= 2
    at = torch.clamp(ends.long() - 1, 0, PC - 1)
    vals = x[:, at].T                                       # [K, rows]
    valid = si[at].long() == torch.arange(K, device=slab.device)
    return torch.where(valid[:, None], vals, torch.zeros_like(vals))


_SEG_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_longlong] + [ctypes.c_void_p] * 2
                 + [ctypes.c_int] + [ctypes.c_void_p] * 3)


def seg_lib(lib=None):
    """The reduction's library (default: the package's build) with its C
    functions' argument types set."""
    lib = lib or build.load("seg_reduce")
    lib.seg_reduce_launch.argtypes = _SEG_ARGTYPES
    lib.seg_reduce_launch.restype = ctypes.c_int
    lib.seg_reduce_scratch_ints.argtypes = [ctypes.c_int, ctypes.c_longlong]
    lib.seg_reduce_scratch_ints.restype = ctypes.c_longlong
    return lib


def seg_reduce_launch(lib, slab, pair_idx, per_rank_counts):
    """Launches one build's reduction on checked CUDA inputs into a new
    [K, rows] float32 tensor, on the current stream."""
    PC, rows = slab.shape
    K = per_rank_counts.shape[0]
    dev = slab.device
    out = torch.empty((K, rows), dtype=torch.float32, device=dev)
    if K == 0:
        return out
    scratch = torch.empty(lib.seg_reduce_scratch_ints(K, PC),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.seg_reduce_launch(
            slab.data_ptr(), int(slab.dtype == torch.bfloat16), rows, PC,
            pair_idx.data_ptr(), per_rank_counts.data_ptr(), K,
            scratch.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"seg_reduce launch failed: CUDA error {err}")
    return out


def seg_reduce(slab, pair_idx, per_rank_counts, kmax: int):
    """Per-rank sums of the slab rows -> [K, rows] float32 (see
    seg_reduce_plain). ``pair_idx`` [PC] int32 holds each pair's depth
    rank (ids >= K reach no rank), ``per_rank_counts`` [K] int32 the pairs
    each rank emitted; ``kmax`` bounds those counts (the plain version's
    scan passes).

    On CUDA tensors it launches ``csrc/seg_reduce.cu`` on the current
    stream, which sorts nothing: integer atomics drop each pair into its
    rank's bucket, and each rank orders its bucket before summing it, so
    two launches agree bit for bit; runs of any length. It adds one to
    ``seg_reduce.launches``. There a slab that is not 16-byte aligned
    raises ValueError, and more than 2^20 ranks or 2^31 - 1 pairs make the
    launch fail (RuntimeError). On CPU tensors it runs the plain version.
    This is the port's counterpart of the reference's ``_reduce_to_gauss``:
    run ends come from the emitted counts, exact when nothing was dropped;
    when pairs were dropped, a rank whose run end does not land in its own
    run gets zeros, as in the reference."""
    if slab.dim() != 2 or slab.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"slab must be 2-D float32 or bfloat16, got "
                         f"{slab.dtype} {tuple(slab.shape)}")
    PC, rows = slab.shape
    if rows not in (8, 16, 32):
        raise ValueError(f"slab rows {rows}: 8, 16 or 32")
    if PC == 0:
        raise ValueError("empty pair array")
    for name, x, n in (("pair_idx", pair_idx, PC),
                       ("per_rank_counts", per_rank_counts, None)):
        if x.dtype != torch.int32 or x.dim() != 1 or (
                n is not None and x.shape[0] != n):
            raise ValueError(f"{name} must be int32 [{n or 'K'}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != slab.device:
            raise ValueError(f"{name} is on {x.device}, slab on "
                             f"{slab.device}")
    dev = slab.device
    if dev.type == "cpu":
        return seg_reduce_plain(slab, pair_idx, per_rank_counts, kmax)
    _require_cuda("seg_reduce", dev, {"slab": slab, "pair_idx": pair_idx,
                                      "per_rank_counts": per_rank_counts})
    if slab.data_ptr() % 16:
        raise ValueError("the CUDA reduction reads 16-byte aligned rows")
    out = seg_reduce_launch(seg_lib(), slab, pair_idx, per_rank_counts)
    seg_reduce.launches += 1
    return out


seg_reduce.launches = 0


def _backward_impl(pr, gpair, fwd_out, cot, order, origins, width, height,
                   cfg, n, C, mesh=None, axis="tile"):
    """Per-Gaussian grads (du, dv, dca, dcb, dcc, dop, ddepth, dcolors) in
    the unsorted order; the first K depth ranks (cfg.visible_cap) carry
    them, ranks past K get zeros.

    With ``mesh``, ``fwd_out`` and the build_pairs dict are this rank's
    block of tile rows and ``cot`` the whole image's [T, C+2, P] cotangent,
    the same on every rank: the rank takes its rows of it (zeros on the
    phantom rows past the image), walks and reduces its own pairs, and the
    one collective is the sum of the [K, rows] per-Gaussian sums over
    ``axis``."""
    K = n if cfg.visible_cap is None else min(int(cfg.visible_cap), n)
    if mesh is None:
        kmax = pairs_mod.big_tiles_for(cfg, width, height)
    else:
        D, d = mesh.shape[axis], mesh.index(axis)
        _, H_local, Tl = _shard_rows(width, height, cfg.tile_size, D)
        cot = torch.nn.functional.pad(
            cot, (0, 0, 0, 0, 0, D * Tl - cot.shape[0]))[d * Tl:(d + 1) * Tl]
        kmax = pairs_mod.big_tiles_for(cfg, width, H_local)
    cot = cot.contiguous()
    jhi = _jhi(fwd_out, pr["starts"], pr["counts"], C)
    slab = bwd_pairwalk(gpair, pr["starts"], pr["counts"], origins, jhi,
                        fwd_out, cot, C, cfg)
    seg = seg_reduce(slab, pr["pair_idx"], pr["per_rank_counts"], kmax)
    if mesh is not None:
        seg = mesh.all_reduce(seg, axis)
    full = seg.new_zeros((n, seg.shape[1]))
    full.index_copy_(0, order[:K].long(), seg)
    return (full[:, R_X], full[:, R_Y], full[:, R_CA], full[:, R_CB],
            full[:, R_CC], full[:, R_OP], full[:, R_DEPTH],
            full[:, N_FIXED:N_FIXED + C])


# --------------------------------------------------------------------------
# autograd boundary and image assembly
# --------------------------------------------------------------------------

_PR_KEYS = ("starts", "counts", "pair_idx", "per_rank_counts")


class _BlendPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, ca, cb, cc, opacity, depth, colors, rx, ry,
                visible_f, order, width, height, cfg, mesh, axis):
        out, pr, gpair, origins = _forward_impl(
            (u, v), (ca, cb, cc), opacity, depth, colors, (rx, ry),
            visible_f > 0.5, order, width, height, cfg, mesh, axis)
        counters = (pr["n_dropped"], pr["n_trunc"], pr["n_vis_dropped"])
        ctx.save_for_backward(gpair, out, origins, order,
                              *(pr[k] for k in _PR_KEYS))
        ctx.meta = (width, height, cfg, u.shape[0], colors.shape[-1], mesh,
                    axis)
        if mesh is not None:
            # the drop counters summed over the ranks (n_vis_dropped is the
            # same on every rank), and every rank's rows of the image: the
            # caller's loss sees the whole image on every rank
            summed = mesh.all_reduce(torch.stack(counters[:2]), axis)
            counters = (summed[0], summed[1], counters[2])
            T = (-(-width // cfg.tile_size)) * (-(-height // cfg.tile_size))
            out = mesh.all_gather(out, axis)[:T]
        ctx.mark_non_differentiable(*counters)
        return (out,) + counters

    @staticmethod
    def backward(ctx, d_out, *_counter_grads):
        """Mirrors the JAX package's _blend_bwd_rule: the n_contrib and
        t_final cotangents and the drop counters' are dropped; the binning
        inputs (radius, visible_f, order) get no gradient. Under a mesh the
        cotangent of the gathered image is the same on every rank (the loss
        is computed on every rank), so it is not summed over ranks: each
        rank takes its own rows of it (_backward_impl)."""
        gpair, out, origins, order, *pr_vals = ctx.saved_tensors
        width, height, cfg, n, C, mesh, axis = ctx.meta
        none9 = (None,) * 9
        if d_out is None:
            return (None,) * 8 + none9
        pr = dict(zip(_PR_KEYS, pr_vals))
        grads = _backward_impl(pr, gpair, out, d_out[:, :C + 2], order,
                               origins, width, height, cfg, n, C, mesh, axis)
        return grads + none9


def blend_pairs(xy, conic, opacity, depth, colors, radius, visible_f, order,
                width: int, height: int, cfg: RasterConfig, mesh=None,
                axis: str = "tile"):
    """Differentiable pair blend over UNSORTED per-Gaussian screen
    quantities: ``xy`` is the tuple (u, v), ``conic`` (a, b, c), ``radius``
    (rx, ry); ``order`` is the integer depth permutation. radius/visible_f/
    order direct the binning only and get no gradient. With ``mesh`` (a
    ``dist.multihost.Mesh``), the tile rows shard over its ``axis``: each
    rank bins, walks and reduces only its own rows' pairs, and the result
    is the same on every rank (see _BlendPairs).

    Returns (acc [T, C+4, P] attr-major, n_dropped, n_trunc,
    n_vis_dropped): C channels, expected depth, alpha (the sum of blend
    weights), n_contrib and t_final. Gradients flow to xy, conic, opacity,
    depth and colors through the backward walk and the reduction."""
    u, v = xy
    ca, cb, cc = conic
    rx, ry = radius
    return _BlendPairs.apply(u, v, ca, cb, cc, opacity, depth, colors, rx,
                             ry, visible_f, order, width, height, cfg, mesh,
                             axis)


def assemble_image(acc, width, height, cfg, bg):
    """[T, C+4, P] raw attr-major accumulators -> (image [H,W,C], depth,
    alpha)."""
    ts = cfg.tile_size
    gx = -(-width // ts)
    gy = -(-height // ts)
    C = acc.shape[1] - 4
    img = (acc[:, :C, :]
           + (1.0 - acc[:, C + 1, :])[:, None, :] * bg[None, :, None])

    def asm(x, ch):
        x = x.reshape(gy, gx, ch, ts, ts)
        x = x.permute(0, 3, 1, 4, 2).reshape(gy * ts, gx * ts, ch)
        return x[:height, :width]

    image = asm(img, C)
    depth = asm(acc[:, C:C + 1, :], 1)[..., 0]
    alpha = asm(acc[:, C + 1:C + 2, :], 1)[..., 0]
    return image, depth, alpha
