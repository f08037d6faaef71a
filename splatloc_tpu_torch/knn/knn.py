"""simple-knn equivalent: mean squared distance to the 3 nearest neighbors.

Port of ``splatloc_tpu.knn.knn``. The reference calls
``simple_knn._C.distCUDA2(points) -> [N]`` for the initial Gaussian scale
(gaussian_model.py:18,206). The default here is the exact tiled
computation: |x-y|^2 = |x|^2 + |y|^2 - 2 x.y makes each tile of the N^2
distance matrix one matrix product (torch.matmul, as the JAX package leaves
it to XLA). ``mean_dist2_3nn_approx`` keeps the Morton-sorted windowed
variant for very large N.
"""
from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits of v over 30 bits (classic Morton interleave), with
    the JAX package's uint32 wrap-around multiplies done in int64 and
    masked to 32 bits."""
    v = ((v * 0x00010001) & _U32) & 0xFF0000FF
    v = ((v * 0x00000101) & _U32) & 0x0F00F00F
    v = ((v * 0x00000011) & _U32) & 0xC30C30C3
    v = ((v * 0x00000005) & _U32) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, valid: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """[N,3] -> [N] Morton codes (uint32 values in int64), normalized to the
    cloud bbox of the valid points."""
    if valid is None:
        valid = torch.ones(points.shape[:1], dtype=torch.bool,
                           device=points.device)
    inf = torch.full_like(points, float("inf"))
    lo = torch.amin(torch.where(valid[:, None], points, inf), dim=0)
    hi = torch.amax(torch.where(valid[:, None], points, -inf), dim=0)
    extent = torch.clamp(hi - lo, min=1e-9)
    q = torch.clamp((points - lo) / extent * 1023.0, 0.0, 1023.0).to(
        torch.int64)
    x = _expand_bits(q[:, 0])
    y = _expand_bits(q[:, 1])
    z = _expand_bits(q[:, 2])
    return (x << 2) | (y << 1) | z


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """|p|^2 of [N,3] rows rounded as XLA's fused reduction rounds it: a
    chain of fused multiply-adds (each product of two float32 values is
    exact in float64, so one rounding per step)."""
    x, y, z = (p[:, i].double() for i in range(3))
    return (z * z + (y * y + (x * x).float().double()).float().double()
            ).float()


def _mean_of_finite(kd2: torch.Tensor) -> torch.Tensor:
    """Mean over the finite entries of the last axis (0 where none)."""
    finite = torch.isfinite(kd2)
    s = torch.sum(torch.where(finite, kd2, torch.zeros_like(kd2)), dim=-1)
    cnt = torch.clamp(torch.sum(finite, dim=-1), min=1)
    return s / cnt


def mean_dist2_3nn_approx(points: torch.Tensor,
                          valid: torch.Tensor | None = None,
                          window: int = 16, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbors among the
    ``window`` Morton-order neighbors on each side (approximate, like the
    reference's Morton boxes). Invalid points are no one's neighbor and get
    0."""
    N = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    codes = morton_codes(points, valid)
    key = torch.where(valid, codes, torch.full_like(codes, _U32))
    order = torch.argsort(key, stable=True)
    pts = points[order]
    val = valid[order]
    offsets = torch.cat([torch.arange(-window, 0, device=dev),
                         torch.arange(1, window + 1, device=dev)])
    idx = torch.arange(N, device=dev)[:, None] + offsets[None, :]
    in_range = (idx >= 0) & (idx < N)
    idx_c = torch.clamp(idx, 0, N - 1)
    nbr = pts[idx_c]                                         # [N, 2W, 3]
    nbr_valid = in_range & val[idx_c] & val[:, None]
    d2 = torch.sum((nbr - pts[:, None, :]) ** 2, dim=-1)
    d2 = torch.where(nbr_valid, d2, torch.full_like(d2, float("inf")))
    kd2 = -torch.topk(-d2, k, dim=-1).values                 # k smallest
    mean = _mean_of_finite(kd2)
    out = torch.zeros((N,), dtype=points.dtype, device=dev)
    out[order] = torch.where(val, mean, torch.zeros_like(mean))
    return out


def knn_exact(points: torch.Tensor, valid: torch.Tensor | None = None,
              k: int = 3, block: int = 1024) -> torch.Tensor:
    """Exact k-NN mean squared distance via tiled pairwise distances
    (O(N^2), one matrix product per tile of ``block`` points)."""
    N = points.shape[0]
    dev = points.device
    if valid is None:
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
    pad = (-N) % block
    pts = torch.cat([points, points.new_zeros((pad, 3))])
    val = torch.cat([valid, valid.new_zeros((pad,))])
    M = pts.shape[0]
    sq = _sq_norm(pts)
    cols = torch.arange(M, device=dev)
    out = []
    for b0 in range(0, M, block):
        cpts = pts[b0:b0 + block]
        cross = cpts @ pts.T                                 # [B, M]
        d2 = sq[None, :] + sq[b0:b0 + block, None] - 2 * cross
        self_mask = (b0 + torch.arange(block, device=dev))[:, None] == cols
        d2 = torch.where(val[None, :] & ~self_mask, d2,
                         torch.full_like(d2, float("inf")))
        kd2 = -torch.topk(-d2, k, dim=-1).values
        kd2 = torch.where(torch.isfinite(kd2), torch.clamp(kd2, min=0.0),
                          kd2)
        m = _mean_of_finite(kd2)
        out.append(torch.where(val[b0:b0 + block], m, torch.zeros_like(m)))
    return torch.cat(out)[:N]


# Default distCUDA2 replacement: exact.
mean_dist2_3nn = knn_exact
