"""Plain Gaussian splatting: EWA projection, per-tile depth-ordered lists
and front-to-back alpha compositing in ordinary torch operations, with
autograd for the gradients.

The benchmark's reference for the mapping step. It imports nothing of the
program. Its arithmetic follows the reference rasterizer's rules as the port
states them: pixel centres on the integer grid (u = fx x/z + cx - 0.5), the
tangent clamp of computeCov2D, a 0.3 px low-pass, radius ceil(3 sqrt(l1)),
a Gaussian blended only in the tiles of its rectangle (the rectangle
tightened to the alpha >= 1/255 ellipse), alpha = min(0.99, o exp(power))
kept where power <= 0 and alpha >= 1/255, and a pixel stopping before the
Gaussian that takes its transmittance below 1e-4.

``render(..., counts=True)`` also counts the work the pair walks must do
on the view (pairs, evaluations up to each pixel's last blended pair, the
blended evaluations): the numbers behind the walks' rooflines.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

SH_C0 = 0.28209479177387814
TILE = 16
NEAR = 0.2
BLUR = 0.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
TILES_PER_CHUNK = 32


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """[N,4] (w, x, y, z), any norm -> [N,3,3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


def project(xyz, scales, quats, opac, w2c, K: Intrinsics, alive):
    """Screen-space Gaussians: (u, v, z, conic [N,3], visible, tile rect
    (x0, x1, y0, y1) as long tensors)."""
    R, t = w2c[:3, :3], w2c[:3, 3]
    p = xyz @ R.T + t
    x, y, z = p.unbind(-1)
    front = z > NEAR
    zs = torch.where(front, z, torch.ones_like(z))
    u = K.fx * x / zs + (K.cx - 0.5)
    v = K.fy * y / zs + (K.cy - 0.5)
    limx = 1.3 * (0.5 * K.width / K.fx)
    limy = 1.3 * (0.5 * K.height / K.fy)
    tx = (x / zs).clamp(-limx, limx) * zs
    ty = (y / zs).clamp(-limy, limy) * zs
    zero = torch.zeros_like(z)
    J = torch.stack([
        torch.stack([K.fx / zs, zero, -K.fx * tx / (zs * zs)], -1),
        torch.stack([zero, K.fy / zs, -K.fy * ty / (zs * zs)], -1)], -2)
    M = quat_to_rot(quats) * scales[:, None, :]
    cov_w = M @ M.transpose(1, 2)
    T = J @ R[None]
    cov = T @ cov_w @ T.transpose(1, 2)
    c00 = cov[:, 0, 0] + BLUR
    c01 = cov[:, 0, 1]
    c11 = cov[:, 1, 1] + BLUR
    det = c00 * c11 - c01 * c01
    ok = det > 0
    det_s = torch.where(ok, det, torch.ones_like(det))
    conic = torch.stack([c11 / det_s, -c01 / det_s, c00 / det_s], -1)
    mid = 0.5 * (c00 + c11)
    lam = mid + torch.sqrt((mid * mid - det_s).clamp_min(0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    cut = torch.sqrt((2.0 * torch.log(opac.detach().clamp_min(1e-12)
                                      / ALPHA_MIN) + 0.05).clamp_min(0.0))
    rx = torch.minimum(cut * torch.sqrt(c00.detach().clamp_min(0.0)), radius)
    ry = torch.minimum(cut * torch.sqrt(c11.detach().clamp_min(0.0)), radius)
    gx, gy = -(-K.width // TILE), -(-K.height // TILE)
    ud, vd = u.detach(), v.detach()

    def rect(c, r, n):
        return (torch.floor((c - r) / TILE).clamp(0, n).long(),
                (torch.floor((c + r) / TILE) + 1).clamp(0, n).long())
    x0, x1 = rect(ud, rx, gx)
    y0, y1 = rect(vd, ry, gy)
    sq0, sq1 = rect(ud, radius, gx)
    sy0, sy1 = rect(vd, radius, gy)
    nonempty = (sq1 - sq0) * (sy1 - sy0) > 0
    vis = front & ok & alive & nonempty
    return u, v, z, conic, vis, (x0, x1, y0, y1)


def _tile_lists(vis, z, rects, K: Intrinsics):
    """Depth-ordered pair lists: (order [Nv] of visible Gaussians,
    lists [T, Kmax] of ranks into ``order`` with Nv as padding, counts
    [T])."""
    dev = z.device
    key = torch.where(vis, z.detach(), torch.full_like(z, float("inf")))
    order = torch.argsort(key, stable=True)[:int(vis.sum())]
    x0, x1, y0, y1 = (r[order] for r in rects)
    w = (x1 - x0).clamp_min(0)
    area = w * (y1 - y0).clamp_min(0)
    nv = order.shape[0]
    rank = torch.repeat_interleave(torch.arange(nv, device=dev), area)
    first = torch.cumsum(area, 0) - area
    local = torch.arange(rank.shape[0], device=dev) - first[rank]
    wr = w[rank].clamp_min(1)
    tile = (y0[rank] + local // wr) * (-(-K.width // TILE)) + x0[rank] + (
        local % wr)
    T = (-(-K.width // TILE)) * (-(-K.height // TILE))
    srt = torch.argsort(tile * (nv + 1) + rank)
    tile, rank = tile[srt], rank[srt]
    counts = torch.bincount(tile, minlength=T)
    kmax = max(int(counts.max()), 1) if counts.numel() else 1
    starts = torch.cumsum(counts, 0) - counts
    col = torch.arange(tile.shape[0], device=dev) - starts[tile]
    lists = torch.full((T, kmax), nv, dtype=torch.long, device=dev)
    lists[tile, col] = rank
    return order, lists, counts


def _blend(origin, xy, conic, op, col, dep, valid):
    """Composite a batch of tiles: origin [B,2]; per-pair [B,K,...]
    attributes. Returns (rgbc [B,P,C], depth [B,P], alpha [B,P], w
    [B,K,P], keep [B,K,P])."""
    g = torch.arange(TILE, dtype=xy.dtype, device=xy.device)
    py = g[:, None].expand(TILE, TILE).reshape(-1)
    px = g[None, :].expand(TILE, TILE).reshape(-1)
    dx = xy[..., 0:1] - (origin[:, None, 0:1] + px)
    dy = xy[..., 1:2] - (origin[:, None, 1:2] + py)
    a, b, c = conic[..., 0:1], conic[..., 1:2], conic[..., 2:3]
    power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
    alpha = (op[..., None] * torch.exp(power)).clamp(max=ALPHA_MAX)
    keep = (power <= 0) & (alpha >= ALPHA_MIN) & valid[..., None]
    alpha = torch.where(keep, alpha, torch.zeros_like(alpha))
    t_inc = torch.cumprod(1.0 - alpha, dim=1)
    t_exc = torch.cat([torch.ones_like(t_inc[:, :1]), t_inc[:, :-1]], 1)
    w = alpha * t_exc * (t_inc >= T_EPS).to(alpha.dtype)
    wt = w.transpose(1, 2)
    return (wt @ col, (wt @ dep[..., None])[..., 0], w.sum(1), w, keep)


def render(xyz, scaling, rotation, opacity, f_dc, kp_score, alive, w2c,
           K: Intrinsics, counts: bool = False):
    """(image [H,W,4] (RGB + composited kp logit), depth [H,W], alpha
    [H,W]) of the view ``w2c`` from raw parameters (log-scales, opacity
    logits, SH DC), black background; with ``counts`` also a dict of the
    walks' work on this view."""
    dev = xyz.device
    opac = torch.sigmoid(opacity[:, 0])
    u, v, z, conic, vis, rects = project(xyz, torch.exp(scaling), rotation,
                                         opac, w2c, K, alive)
    rgb = (SH_C0 * f_dc[:, 0, :] + 0.5).clamp_min(0.0)
    colors = torch.cat([rgb, kp_score], -1)
    order, lists, cnt = _tile_lists(vis, z, rects, K)
    nv = order.shape[0]

    def pad(x):
        return torch.cat([x[order], x.new_zeros((1,) + x.shape[1:])])
    xy_s = pad(torch.stack([u, v], -1))
    con_s, op_s, col_s, dep_s = pad(conic), pad(opac), pad(colors), pad(z)
    gx, gy = -(-K.width // TILE), -(-K.height // TILE)
    T = gx * gy
    tiles = torch.arange(T, device=dev)
    origins = torch.stack([(tiles % gx) * TILE, (tiles // gx) * TILE],
                          -1).to(xyz.dtype)
    by_count = torch.argsort(cnt, descending=True, stable=True)
    cnt_host = cnt[by_count].tolist()
    grad = torch.is_grad_enabled() and xyz.requires_grad
    outs, work = [], {"pairs": float(cnt.sum()), "evals_fwd": 0.0,
                      "evals_bwd": 0.0, "blended": 0.0, "needed_pairs": 0.0,
                      "visible": float(nv)}

    def chunk_fn(origin, li, xy_s, con_s, op_s, col_s, dep_s):
        return _blend(origin, xy_s[li], con_s[li], op_s[li], col_s[li],
                      dep_s[li], li < nv)[:3]

    for pos in range(0, T, TILES_PER_CHUNK):
        idx = by_count[pos:pos + TILES_PER_CHUNK]
        k = max(cnt_host[pos], 1)
        li = lists[idx, :k]
        args = (origins[idx], li, xy_s, con_s, op_s, col_s, dep_s)
        if grad:
            outs.append(checkpoint(chunk_fn, *args, use_reentrant=False))
        else:
            outs.append(chunk_fn(*args))
        if counts:
            *_, w, keep = _blend(origins[idx], xy_s[li], con_s[li],
                                 op_s[li], col_s[li], dep_s[li], li < nv)
            kk = torch.arange(1, k + 1, device=dev)[None, :, None]
            last = torch.amax(torch.where(w > 0, kk, 0), dim=1)   # [B,P]
            tc = cnt[idx][:, None].expand_as(last)
            work["evals_fwd"] += float(torch.where(last > 0, last,
                                                   tc).double().sum())
            work["evals_bwd"] += float(last.double().sum())
            work["blended"] += float((keep & (kk <= last[:, None, :])
                                      ).double().sum())
            work["needed_pairs"] += float(last.amax(1).double().sum())
    out_c, out_d, out_a = (torch.cat(x) for x in zip(*outs))
    inv = torch.argsort(by_count)
    out_c, out_d, out_a = out_c[inv], out_d[inv], out_a[inv]

    def assemble(x, ch):
        x = x.reshape(gy, gx, TILE, TILE, ch).permute(0, 2, 1, 3, 4)
        return x.reshape(gy * TILE, gx * TILE, ch)[:K.height, :K.width]
    image = assemble(out_c, colors.shape[-1])
    depth = assemble(out_d[..., None], 1)[..., 0]
    alpha = assemble(out_a[..., None], 1)[..., 0]
    if counts:
        return image, depth, alpha, work
    return image, depth, alpha
