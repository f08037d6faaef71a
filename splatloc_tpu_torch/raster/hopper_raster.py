"""Pair-walk rasterization core for Hopper: the forward blend over
sort-binned (Gaussian, tile) pairs.

Counterpart of ``splatloc_tpu.raster.pallas_raster`` (forward only). Per
tile, the walk composites the tile's contiguous, 128-aligned segment of the
depth-sorted per-pair attribute table front to back. Alignment padding pairs
carry Gaussian index K, whose attributes are all zero, so they are inert.

The kernel is ``csrc/fwd_pairwalk.cu`` (replacing ``_fwd_kernel``), launched
through ``fwd_pairwalk``; ``fwd_pairwalk_plain`` beside it is the same
function in plain PyTorch: the CPU path and the oracle the kernel is held
against on the card. ``blend_pairs`` is a ``torch.autograd.Function`` whose
backward (the backward pair-walk kernel) is not ported yet and raises.
"""
from __future__ import annotations

import ctypes

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
    _, origins = _origins(width, height, cfg.tile_size)

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
    return gpair, pr, torch.from_numpy(origins).to(gpair.device)


def _forward_impl(xy, conic, opacity, depth, colors, radius, visible, order,
                  width, height, cfg):
    """(acc [T, C+4, P], the build_pairs dict, gpair) of one render."""
    gpair, pr, origins = _pair_inputs(xy, conic, opacity, depth, colors,
                                      radius, visible, order, width, height,
                                      cfg)
    out = fwd_pairwalk(gpair, pr["starts"], pr["counts"], origins,
                       colors.shape[-1], cfg)
    return out, pr, gpair


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


_LAUNCH_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]


def _kernel_lib():
    lib = build.load("fwd_pairwalk")
    lib.fwd_pairwalk_launch.argtypes = _LAUNCH_ARGTYPES
    lib.fwd_pairwalk_launch.restype = ctypes.c_int
    lib.fwd_pairwalk_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]
    lib.fwd_pairwalk_info.restype = ctypes.c_int
    return lib


def fwd_pairwalk_info(n_channels: int, cfg: RasterConfig) -> dict:
    """The kernel's launch shape on the current CUDA device: threads and
    dynamic shared memory per block, and the blocks that fit on one SM."""
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    err = _kernel_lib().fwd_pairwalk_info(n_channels, cfg.tile_size,
                                          ctypes.byref(smem),
                                          ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"fwd_pairwalk_info failed: CUDA error {err}")
    return {"threads": cfg.tile_size ** 2, "smem_bytes": smem.value,
            "blocks_per_sm": blocks.value}


def fwd_pairwalk(gpair, starts, counts, origins, n_channels: int,
                 cfg: RasterConfig):
    """Forward pair walk -> [T, C+4, P] (see fwd_pairwalk_plain).

    On CUDA tensors it launches the kernel ``csrc/fwd_pairwalk.cu`` on the
    current stream and adds one to ``fwd_pairwalk.launches``; on CPU
    tensors it runs the plain version. Any other device, a wrong dtype or
    shape, or a non-contiguous tensor raises."""
    dev = gpair.device
    _check_inputs(gpair, starts, counts, origins, n_channels, cfg)
    if dev.type == "cpu":
        return fwd_pairwalk_plain(gpair, starts, counts, origins, n_channels,
                                  cfg)
    if dev.type != "cuda":
        raise ValueError(f"fwd_pairwalk runs on cuda or cpu, not {dev}")
    for name, x in (("gpair", gpair), ("starts", starts), ("counts", counts),
                    ("origins", origins)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
# autograd boundary and image assembly
# --------------------------------------------------------------------------

class _BlendPairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, v, ca, cb, cc, opacity, depth, colors, rx, ry,
                visible_f, order, width, height, cfg):
        out, pr, _ = _forward_impl((u, v), (ca, cb, cc), opacity, depth,
                                   colors, (rx, ry), visible_f > 0.5, order,
                                   width, height, cfg)
        counters = (pr["n_dropped"], pr["n_trunc"], pr["n_vis_dropped"])
        ctx.mark_non_differentiable(*counters)
        return (out,) + counters

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("backward pair-walk kernel: ROADMAP "
                                  "slice 2")


def blend_pairs(xy, conic, opacity, depth, colors, radius, visible_f, order,
                width: int, height: int, cfg: RasterConfig):
    """Pair blend over UNSORTED per-Gaussian screen quantities: ``xy`` is
    the tuple (u, v), ``conic`` (a, b, c), ``radius`` (rx, ry); ``order``
    is the integer depth permutation. radius/visible_f/order direct the
    binning only.

    Returns (acc [T, C+4, P] attr-major, n_dropped, n_trunc,
    n_vis_dropped): C channels, expected depth, alpha (the sum of blend
    weights), n_contrib and t_final. Asking for gradients through it raises
    NotImplementedError until the backward kernel is ported."""
    u, v = xy
    ca, cb, cc = conic
    rx, ry = radius
    return _BlendPairs.apply(u, v, ca, cb, cc, opacity, depth, colors, rx,
                             ry, visible_f, order, width, height, cfg)


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
