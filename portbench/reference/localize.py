"""Plain query path: landmark selection (utils/selection.py), the
hash-grid descriptor field (models/decoders.py: tiny-cuda-nn's HashGrid and
a bias-free ReLU MLP), the frustum of a database view, descriptor
similarity with the 0.4 cut and an optimal assignment (utils/match_utils.py,
scipy's solver), and PnP + RANSAC with a final Gauss-Newton on the strict
inliers (test.py:64-84's pycolmap call, 12 px).

NumPy and plain torch only; nothing of the program. ``low`` runs a stage
one precision step below what the configuration states: int8 operands
(per-tensor scale) for the decoder's bfloat16 ones, TF32 operands (10
mantissa bits) for the float32 products of the selection and PnP.
"""
from __future__ import annotations

import math

import numpy as np
import torch

PRIMES = (1, 2654435761, 805459861)
U32 = 0xFFFFFFFF


def tf32(x):
    """Round float32 values to TF32's 10-bit mantissa (nearest, ties
    away), as a tensor core reads its operands."""
    if isinstance(x, torch.Tensor):
        i = x.float().contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    i = np.ascontiguousarray(x, np.float32).view(np.int32)
    return ((i + 0x1000) & ~0x1FFF).view(np.float32)


def int8(x: torch.Tensor) -> torch.Tensor:
    s = x.abs().amax().clamp_min(1e-30) / 127.0
    return torch.round(x / s).clamp(-127, 127) * s


# -- selection --------------------------------------------------------

def _saliency_chunk(points, w2cs, K, depths, low: bool):
    """One block of views, float32 on the device (as the configuration
    states): per-point depth-difference sums and counts, the angular-span
    matrix sum and the visible count."""
    f = tf32 if low else (lambda a: a)
    V, H, W = depths.shape
    cam = (torch.einsum("vij,nj->vni", f(w2cs[:, :3, :3]), f(points))
           + w2cs[:, None, :3, 3])
    z = cam[..., 2]
    zs = torch.where(torch.abs(z) > 1e-9, z, torch.full_like(z, 1e-9))
    u = K[0, 0] * cam[..., 0] / zs + K[0, 2]
    v = K[1, 1] * cam[..., 1] / zs + K[1, 2]
    inside = (z > 0.01) & (u > 0) & (u < W) & (v > 0) & (v < H)
    ui = torch.clamp(u.to(torch.int32), 0, W - 1).long()
    vi = torch.clamp(v.to(torch.int32), 0, H - 1).long()
    d = torch.gather(depths.reshape(V, -1), 1,
                     (vi * W + ui).reshape(V, -1)).reshape(z.shape)
    diff = torch.abs(z - d)
    ok = inside & (diff < 0.3) & (d > 0.02)
    zero = torch.zeros_like(diff)
    b = torch.einsum("vji,vnj->vni", f(w2cs[:, :3, :3]),
                     f(points[None] - w2cs[:, None, :3, 3]))
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True),
                        min=1e-12)
    outer = torch.einsum("vni,vnj->vnij", b, b)
    eye = torch.eye(3, device=points.device)[None, None]
    Hm = torch.sum(torch.where(inside[..., None, None], eye - outer,
                               torch.zeros_like(outer)), dim=0)
    return (torch.sum(torch.where(ok, diff, zero), 0),
            torch.sum(torch.where(ok, diff * diff, zero), 0),
            torch.sum(ok, 0), Hm, torch.sum(inside, 0))


def saliency(points: np.ndarray, w2cs: np.ndarray, K: np.ndarray,
             depths: np.ndarray, device, low: bool = False,
             chunk: int = 16) -> np.ndarray:
    """Per-point depth consistency + angular span over the views
    (utils/selection.py:42-113): float32 products on the device in blocks
    of ``chunk`` views, the blocks summed and the scores formed in float64
    on the host. float32 as the configuration states, and not float64:
    the span's arccos near 1 and the ties of clipped depth scores make the
    greedy pick's order swing with the last bit, so a float64 reference
    would pick another, equally valid set. ``low``: TF32 operands."""
    N = points.shape[0]
    dev = torch.device(device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)
    pts, Kt = t(points), t(K)
    acc = [np.zeros(N), np.zeros(N), np.zeros(N, np.int64),
           np.zeros((N, 3, 3)), np.zeros(N, np.int64)]
    for s in range(0, w2cs.shape[0], chunk):
        out = _saliency_chunk(pts, t(w2cs[s:s + chunk]), Kt,
                              t(depths[s:s + chunk]), low)
        for a, x in zip(acc, out):
            a += x.cpu().numpy()
    s_d, s_d2, c_d, Hm, c_v = acc
    mean = s_d / np.maximum(c_d, 1)
    std = np.sqrt(np.maximum(s_d2 / np.maximum(c_d, 1) - mean ** 2, 0.0))
    dscore = (np.minimum(2.0, 0.05 / np.maximum(mean, 1e-12))
              + np.minimum(2.0, 0.05 / np.maximum(std, 1e-12)))
    dscore = np.where(c_d > 0, dscore, 0.0)
    Hn = Hm / np.maximum(c_v, 1)[:, None, None]
    eig = np.linalg.eigvalsh(0.5 * (Hn + Hn.transpose(0, 2, 1)))
    span = np.arccos(np.clip(1 - 2.0 * eig[:, 0] / np.maximum(eig[:, 2],
                                                              1e-12), 0, 1))
    return (dscore + np.where(c_v >= 1, span, 0.0)).astype(np.float32)


def greedy_pick(points: np.ndarray, scores: np.ndarray, num: int,
                radius: float = 18.0) -> np.ndarray:
    """Coverage pick by descending score, the radius halving each sweep."""
    order = np.argsort(scores)[::-1]
    sel = np.zeros((num, 3), np.float32)
    sel[0] = points[order[0]]
    n = 1
    while n < num:
        for i in order:
            if (np.linalg.norm(sel[:n] - points[i][None], axis=1)
                    < radius).any():
                continue
            sel[n] = points[i]
            n += 1
            if n == num:
                break
        radius *= 0.5
        if radius < 1e-6:
            return np.resize(sel[:n], (num, 3))
    return sel


# -- descriptor field -------------------------------------------------

def resolutions(bound, voxel: float, levels: int = 16, base: int = 16):
    ext = max(b[1] - b[0] for b in bound)
    desired = max(int(ext / voxel), 16)
    s = math.exp(math.log(desired / base) / (levels - 1))
    return [int(math.floor(base * s ** l)) for l in range(levels)]


def decode(table: torch.Tensor, layers: list, pos: torch.Tensor, bound,
           voxel: float, low: bool = False) -> torch.Tensor:
    """World points [B,3] -> unit descriptors [B, D]: trilinear hash-grid
    features per level (dense indexing where a level's corners fit the
    table, the multiply-xor hash beyond), then the MLP in float32 (int8
    operands where ``low``)."""
    L, T, F = table.shape
    dev = pos.device
    lo = torch.tensor([b[0] for b in bound], dtype=torch.float32, device=dev)
    hi = torch.tensor([b[1] for b in bound], dtype=torch.float32, device=dev)
    p01 = ((pos - lo) / (hi - lo)).clamp(0, 1)
    feats = []
    for l, res in enumerate(resolutions(bound, voxel, L)):
        x = p01 * res
        x0 = torch.floor(x).long().clamp(0, res - 1)
        w = x - x0.float()
        acc = torch.zeros((pos.shape[0], F), dtype=torch.float32, device=dev)
        for c in range(8):
            d = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            ix, iy, iz = (x0[:, k] + d[k] for k in range(3))
            if (res + 1) ** 3 <= T:
                idx = (ix * (res + 1) + iy) * (res + 1) + iz
            else:
                idx = (((ix * PRIMES[0]) & U32) ^ ((iy * PRIMES[1]) & U32)
                       ^ ((iz * PRIMES[2]) & U32)) % T
            wt = 1.0
            for k in range(3):
                wt = wt * (w[:, k] if d[k] else 1 - w[:, k])
            acc = acc + wt[:, None] * table[l, idx]
        feats.append(acc)
    x = torch.cat(feats, -1)
    q = int8 if low else (lambda a: a)
    for i, Wl in enumerate(layers):
        x = q(x) @ q(Wl)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


# -- frustum, matching, pose ------------------------------------------

EDGE_PX = 1e-3


def frustum(points: np.ndarray, w2c: np.ndarray, K: np.ndarray, W: int,
            H: int):
    """(inside, edge) masks of the points: inside the view (z > 0.05,
    raw-K pixel inside the image), and within ``EDGE_PX`` of its edge,
    where float32 rounding may put a point on either side."""
    cam = points.astype(np.float64) @ w2c[:3, :3].T.astype(np.float64) + \
        w2c[:3, 3]
    z = cam[:, 2]
    zs = np.where(np.abs(z) > 1e-9, z, 1e-9)
    u = K[0, 0] * cam[:, 0] / zs + K[0, 2]
    v = K[1, 1] * cam[:, 1] / zs + K[1, 2]
    inside = (z > 0.05) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
    e = EDGE_PX
    edge = (z > 0.05) & (np.minimum(np.minimum(np.abs(u), np.abs(u - W)),
                                    np.minimum(np.abs(v), np.abs(v - H)))
                         < e) & (u > -e) & (u < W + e) & (v > -e) & (
        v < H + e)
    return inside, edge


def similarity(desc_q: np.ndarray, desc_db: np.ndarray, thresh: float = 0.4,
               low: bool = False) -> np.ndarray:
    """Cosine similarities [query, database] in float64, those under
    ``thresh`` set to 0 (TF32 operands where ``low``)."""
    a = desc_q / np.maximum(np.linalg.norm(desc_q, axis=1, keepdims=True),
                            1e-12)
    b = desc_db / np.maximum(np.linalg.norm(desc_db, axis=1, keepdims=True),
                             1e-12)
    if low:
        a, b = tf32(a), tf32(b)
    sim = a.astype(np.float64) @ b.T.astype(np.float64)
    sim[sim < thresh] = 0.0
    return sim


def assign(desc_q: np.ndarray, desc_db: np.ndarray, thresh: float = 0.4,
           low: bool = False):
    """(query index, database index) pairs of the optimal assignment on
    1 - ``similarity``."""
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(1.0 - similarity(desc_q, desc_db, thresh,
                                                  low))


# A pair whose similarity leads every other of its row and of its column,
# and the threshold, by this much keeps its lead under any features within
# the feature check's limit (0.045) of the reference's: the pairs on which
# every sound assignment agrees, however it breaks ties elsewhere.
MARGIN = 0.1


def dominant_pairs(sim: np.ndarray, thresh: float = 0.4,
                   margin: float = MARGIN):
    """(rows, cols) of the pairs of ``sim`` that lead their row and their
    column by ``margin`` and clear ``thresh`` by it."""
    R, C = sim.shape
    if R < 2 or C < 2:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    ar, ac = np.arange(R), np.arange(C)
    rc = sim.argmax(1)
    rtop = sim[ar, rc]
    s = sim.copy()
    s[ar, rc] = -np.inf
    rsec = s.max(1)
    cr = sim.argmax(0)
    s = sim.copy()
    s[cr, ac] = -np.inf
    csec = s.max(0)
    ok = ((cr[rc] == ar) & (rtop >= thresh + margin)
          & (rtop - rsec >= margin) & (rtop - csec[rc] >= margin))
    return ar[ok], rc[ok]


def assignment_misses(desc_q: np.ndarray, desc_db: np.ndarray,
                      matches: np.ndarray, thresh: float = 0.4):
    """(number of dominant pairs, how many of them ``matches`` [2, K]
    (query rows, database columns) pairs otherwise than the optimal
    assignment does)."""
    from scipy.optimize import linear_sum_assignment
    sim = similarity(desc_q, desc_db, thresh)
    _, cols = dominant_pairs(sim, thresh)
    r, c = linear_sum_assignment(1.0 - sim)
    best = dict(zip(c.tolist(), r.tolist()))
    got = dict(zip(np.asarray(matches[1]).tolist(),
                   np.asarray(matches[0]).tolist()))
    return len(cols), sum(got.get(j, -1) != best[j] for j in cols.tolist())


def _so3_exp(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + k
    return (np.eye(3) + math.sin(th) / th * k
            + (1 - math.cos(th)) / th ** 2 * (k @ k))


def _residual(R, t, x, X, low):
    f = tf32 if low else (lambda a: a)
    cam = (f(X) @ f(R.T)).astype(np.float64) + t
    return cam[:, :2] / cam[:, 2:3] - x, cam


def _gauss_newton(R, t, x, X, iters: int, low: bool):
    for _ in range(iters):
        r, cam = _residual(R, t, x, X, low)
        z = cam[:, 2]
        J = np.zeros((x.shape[0], 2, 6))
        # d(proj)/d(cam) times d(cam)/d(twist) for a left update
        J[:, 0, 0], J[:, 0, 2] = 1 / z, -cam[:, 0] / z ** 2
        J[:, 1, 1], J[:, 1, 2] = 1 / z, -cam[:, 1] / z ** 2
        P = np.zeros((x.shape[0], 3, 6))
        P[:, :, :3] = np.eye(3)
        P[:, 0, 4], P[:, 0, 5] = cam[:, 2], -cam[:, 1]
        P[:, 1, 3], P[:, 1, 5] = -cam[:, 2], cam[:, 0]
        P[:, 2, 3], P[:, 2, 4] = cam[:, 1], -cam[:, 0]
        Jf = (J[:, :2, :3] @ P).reshape(-1, 6)
        dx = np.linalg.lstsq(Jf, -r.reshape(-1), rcond=None)[0]
        dR = _so3_exp(dx[3:])
        R, t = dR @ R, dR @ t + dx[:3]
    return R, t


def _dlt(x, X):
    A = np.zeros((2 * len(X), 12))
    Xh = np.concatenate([X, np.ones((len(X), 1))], 1)
    A[0::2, 0:4], A[0::2, 8:12] = Xh, -x[:, :1] * Xh
    A[1::2, 4:8], A[1::2, 8:12] = Xh, -x[:, 1:2] * Xh
    P = np.linalg.svd(A)[2][-1].reshape(3, 4)
    if np.linalg.det(P[:, :3]) < 0:
        P = -P
    s = np.cbrt(max(np.linalg.det(P[:, :3]), 1e-12))
    P = P / s
    U, _, Vt = np.linalg.svd(P[:, :3])
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = -R
    return R, P[:, 3]


def pnp(q2d: np.ndarray, p3d: np.ndarray, K: np.ndarray, rng,
        inlier_px: float = 12.0, hypotheses: int = 256,
        low: bool = False, start=None):
    """World-to-camera (R, t) from 2D-3D matches:
    6-point DLT hypotheses and ``start`` (the retrieved database pose: a
    DLT on points of one wall is degenerate), each refined on its loose
    inliers, the best by strict inlier count, then Gauss-Newton on its
    strict inliers until they stop changing. None where fewer than 6
    matches or no hypothesis is finite."""
    if len(q2d) < 6:
        return None
    f = 0.5 * (K[0, 0] + K[1, 1])
    x = np.stack([(q2d[:, 0] - K[0, 2]) / K[0, 0],
                  (q2d[:, 1] - K[1, 2]) / K[1, 1]], -1).astype(np.float64)
    X = p3d.astype(np.float64)
    th = inlier_px / f
    best, best_n = None, -1
    for h in range(hypotheses + (start is not None)):
        if h == hypotheses:
            R, t = (np.asarray(a, np.float64) for a in start)
        else:
            s = rng.choice(len(x), 6, replace=False)
            R, t = _dlt(x[s], X[s])
        if not (np.isfinite(R).all() and np.isfinite(t).all()):
            continue
        r, cam = _residual(R, t, x, X, low)
        e = np.where(cam[:, 2] > 0.01, np.linalg.norm(r, axis=1), np.inf)
        loose = e < 3 * th
        if loose.sum() >= 6:
            R, t = _gauss_newton(R, t, x[loose], X[loose], 5, low)
        r, cam = _residual(R, t, x, X, low)
        e = np.where(cam[:, 2] > 0.01, np.linalg.norm(r, axis=1), np.inf)
        n = int((e < th).sum())
        if n > best_n:
            best, best_n = (R, t), n
    if best is None:
        return None
    R, t = best
    inl = None
    for _ in range(10):
        r, cam = _residual(R, t, x, X, low)
        e = np.where(cam[:, 2] > 0.01, np.linalg.norm(r, axis=1), np.inf)
        new = e < th
        if inl is not None and (new == inl).all():
            break
        inl = new
        R, t = _gauss_newton(R, t, x[inl], X[inl], 10, low)
    return R, t


# Near PnP's threshold the set a solver fits is not settled: a pair just
# past it under the final pose may have been inside under the hypothesis
# the final fit started from, and once fitted it pulls the pose by about
# its residual over the inlier count. The pose check therefore accepts the
# least-squares pose of the sure inliers with any subset of the pairs
# within BAND_PX of the threshold (the NEAR_MOST nearest of them).
BAND_PX = 2.0
NEAR_MOST = 6


def pose_gap_near(pose, ref_pose, q2d: np.ndarray, p3d: np.ndarray,
                  K: np.ndarray, pts: np.ndarray,
                  inlier_px: float = 12.0) -> float:
    """The smallest ``pose_gap_px`` over ``pts`` between ``pose`` and the
    least-squares pose (Gauss-Newton from ``ref_pose``) of the pairs under
    ``inlier_px - BAND_PX`` from their key points under ``ref_pose``
    together with any subset of those within ``BAND_PX`` of
    ``inlier_px``."""
    e = reprojection_px(ref_pose, q2d, p3d, K)
    sure = e < inlier_px - BAND_PX
    near = np.nonzero(np.abs(e - inlier_px) < BAND_PX)[0]
    near = near[np.argsort(np.abs(e[near] - inlier_px))][:NEAR_MOST]
    x = np.stack([(q2d[:, 0] - K[0, 2]) / K[0, 0],
                  (q2d[:, 1] - K[1, 2]) / K[1, 1]], -1).astype(np.float64)
    X = p3d.astype(np.float64)
    best = float("inf")
    for bits in range(1 << len(near)):
        fit = sure.copy()
        fit[near[[(bits >> i) & 1 == 1 for i in range(len(near))]]] = True
        R, t = _gauss_newton(np.asarray(ref_pose[0], np.float64),
                             np.asarray(ref_pose[1], np.float64), x[fit],
                             X[fit], 10, False)
        best = min(best, pose_gap_px(pose, (R, t), pts, K))
    return best


def pose_gap_px(pose_a, pose_b, pts: np.ndarray, K: np.ndarray) -> float:
    """RMS over ``pts`` of the distance between their raw-K projections
    under two world-to-camera poses (R, t), in pixels."""
    def proj(R, t):
        cam = pts.astype(np.float64) @ np.asarray(R, np.float64).T + t
        return np.stack([K[0, 0] * cam[:, 0] / cam[:, 2],
                         K[1, 1] * cam[:, 1] / cam[:, 2]], -1)
    d = proj(*pose_a) - proj(*pose_b)
    return float(np.sqrt(np.mean(np.sum(d * d, -1))))


def reprojection_px(pose, q2d: np.ndarray, p3d: np.ndarray,
                    K: np.ndarray) -> np.ndarray:
    """Pixel distance of each 2D-3D pair's raw-K projection under a
    world-to-camera pose (R, t) from its key point."""
    cam = p3d.astype(np.float64) @ np.asarray(pose[0], np.float64).T + \
        pose[1]
    uv = np.stack([K[0, 0] * cam[:, 0] / cam[:, 2] + K[0, 2],
                   K[1, 1] * cam[:, 1] / cam[:, 2] + K[1, 2]], -1)
    return np.linalg.norm(uv - q2d, axis=-1)

