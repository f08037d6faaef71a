"""Minimal 3D landmark selection (reference utils/selection.py:42-157).

Port of ``splatloc_tpu.eval.selection``: the saliency pass is batched over
view chunks on the device (project all points into all views, gather
depths, masked depth-consistency statistics, and the angular-span matrix
H = mean(I - b b^T) accumulated per point); the eigenvalues and the greedy
radius-halving pick (inherently sequential) run on the host exactly like
the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32


def _saliency_chunk(points, w2cs, K, depths, width: int, height: int):
    """One chunk of views: returns per-point accumulators.

    points [N,3]; w2cs [V,4,4]; depths [V,H,W].
    Returns (sum_d, sum_d2, cnt_d, H_acc [N,3,3], cnt_vis).
    """
    cam = (torch.einsum("vij,nj->vni", w2cs[:, :3, :3], points)
           + w2cs[:, None, :3, 3])                                  # [V,N,3]
    z = cam[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = K[0, 0] * cam[..., 0] / zs + K[0, 2]
    v = K[1, 1] * cam[..., 1] / zs + K[1, 2]
    inside = (z > 0.01) & (u > 0) & (u < width) & (v > 0) & (v < height)

    # a cast to int truncates toward zero, as astype(int32) does
    ui = torch.clamp(u.to(torch.int32), 0, width - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, height - 1).long()
    V = depths.shape[0]
    d = torch.gather(depths.reshape(V, -1), 1,
                     (vi * width + ui).reshape(V, -1)).reshape(z.shape)

    diff = torch.abs(z - d)
    dvalid = inside & (diff < 0.3) & (d > 0.02)
    zero = torch.zeros_like(diff)
    sum_d = torch.sum(torch.where(dvalid, diff, zero), dim=0)
    sum_d2 = torch.sum(torch.where(dvalid, diff * diff, zero), dim=0)
    cnt_d = torch.sum(dvalid, dim=0)

    # bearing: exact parity with the reference's bi = Ri^T (p - ti)
    # (utils/selection.py:53-57; Ri/ti taken from the w2c matrix as-is)
    b = torch.einsum("vji,vnj->vni", w2cs[:, :3, :3],
                     points[None] - w2cs[:, None, :3, 3])
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                        min=1e-12)
    outer = torch.einsum("vni,vnj->vnij", b, b)
    eye = torch.eye(3, device=points.device)[None, None]
    H = torch.sum(torch.where(inside[..., None, None], eye - outer,
                              torch.zeros_like(outer)), dim=0)
    cnt_vis = torch.sum(inside, dim=0)
    return sum_d, sum_d2, cnt_d, H, cnt_vis


def _sym3_eigvals(H: np.ndarray):
    """Eigenvalues of symmetric 3x3 matrices [N,3,3] -> [N,3]."""
    return np.linalg.eigvalsh(H)


@full_float32()
def saliency_scores(points: np.ndarray, w2cs: np.ndarray, K: np.ndarray,
                    depths: np.ndarray, view_chunk: int = 16,
                    device="cuda") -> np.ndarray:
    """Per-point saliency = depth-consistency + angular span
    (utils/selection.py:66-81,42-64,108-113)."""
    N = points.shape[0]
    V = w2cs.shape[0]
    H_img, W_img = depths.shape[1:]

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    pts = dev(points)
    Kt = dev(K)

    sum_d = np.zeros(N, np.float64)
    sum_d2 = np.zeros(N, np.float64)
    cnt_d = np.zeros(N, np.int64)
    Hacc = np.zeros((N, 3, 3), np.float64)
    cnt_vis = np.zeros(N, np.int64)
    for s in range(0, V, view_chunk):
        e = min(s + view_chunk, V)
        out = _saliency_chunk(pts, dev(w2cs[s:e]), Kt, dev(depths[s:e]),
                              W_img, H_img)
        sd, sd2, cd, Hc, cv = (x.cpu().numpy() for x in out)
        sum_d += sd
        sum_d2 += sd2
        cnt_d += cd
        Hacc += Hc
        cnt_vis += cv

    mean = sum_d / np.maximum(cnt_d, 1)
    var = np.maximum(sum_d2 / np.maximum(cnt_d, 1) - mean ** 2, 0.0)
    std = np.sqrt(var)
    depth_score = (np.minimum(2.0, 0.05 / np.maximum(mean, 1e-12))
                   + np.minimum(2.0, 0.05 / np.maximum(std, 1e-12)))
    depth_score = np.where(cnt_d > 0, depth_score, 0.0)

    Hn = Hacc / np.maximum(cnt_vis, 1)[:, None, None]
    Hn = 0.5 * (Hn + Hn.transpose(0, 2, 1))
    eig = _sym3_eigvals(Hn)
    lam_min, lam_max = eig[:, 0], eig[:, 2]
    span = np.arccos(np.clip(1 - 2.0 * lam_min / np.maximum(lam_max, 1e-12),
                             0, 1))
    span = np.where(cnt_vis >= 1, span, 0.0)
    return (depth_score + span).astype(np.float32)


def greedy_pick(points: np.ndarray, scores: np.ndarray, num: int,
                radius: float = 18.0) -> np.ndarray:
    """Greedy coverage pick by descending score with radius halving per
    sweep (utils/selection.py:120-145)."""
    order = np.argsort(scores)[::-1]
    selected = np.zeros((num, 3), np.float32)
    selected[0] = points[order[0]]
    n = 1
    while n < num:
        for i in order:
            p = points[i]
            d = np.linalg.norm(selected[:n] - p[None], axis=1)
            if (d < radius).any():
                continue
            selected[n] = p
            n += 1
            if n == num:
                break
        radius *= 0.5
        if radius < 1e-6:
            # degenerate: fewer distinct points than requested
            reps = np.resize(selected[:n], (num, 3))
            return reps
    return selected


def select_landmarks(points: np.ndarray, w2cs: np.ndarray, K: np.ndarray,
                     depths: np.ndarray, num: int, view_chunk: int = 16,
                     device="cuda") -> np.ndarray:
    scores = saliency_scores(points, w2cs, K, depths, view_chunk, device)
    return greedy_pick(points, scores, num)
