"""PnP + RANSAC on the device (replaces pycolmap.absolute_pose_estimation,
reference test.py:64-84).

Port of ``splatloc_tpu.match.pnp``: batched minimal-sample hypotheses
(6-point DLT -> projection matrix -> nearest rotation) scored by
reprojection inliers, each refined by Gauss-Newton on its loose-inlier
support, then a final Gauss-Newton on the winner's strict inliers, all
parameterized by an SE(3) twist. The hypotheses run as one batch (a batched
12x12 SVD). The two Gauss-Newton fits are ``gauss_newton_fit``: on the
card two launches of the kernel ``csrc/pnp_refine.cu``, on the CPU its
plain version (Jacobians by ``torch.func.jacfwd`` of the same residual
under ``vmap``, a batched 6x6 solve).

The JAX package draws each hypothesis' sample from a PRNG key; here
``_solve_core`` takes the random priorities [n_hypotheses, M] as a tensor
and ``solve_pnp_ransac`` draws them from a torch.Generator seeded by
``seed`` (or takes them injected, as the parity tests inject JAX's own).

Returns the camera-to-world rotation/translation like the reference
``solve_pose`` (it inverts the solved world-to-camera pose).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.func import jacfwd, vmap

from splatloc_tpu_torch import build
from splatloc_tpu_torch.core import transforms
from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.utils.profiling import span


def _dlt_pose(pts2d_n: torch.Tensor, pts3d: torch.Tensor):
    """6+ point DLT for [R|t] from normalized image coords, batched.

    pts2d_n [B,S,2] (x/z, y/z in camera normalized coords), pts3d [B,S,3].
    Returns (R [B,3,3], t [B,3], ok [B]).
    """
    B, S = pts3d.shape[:2]
    X = torch.cat([pts3d, pts3d.new_ones((B, S, 1))], dim=-1)      # [B,S,4]
    zeros = torch.zeros_like(X)
    u = pts2d_n[..., 0:1]
    v = pts2d_n[..., 1:2]
    rows_u = torch.cat([X, zeros, -u * X], dim=-1)                  # [B,S,12]
    rows_v = torch.cat([zeros, X, -v * X], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=1)                          # [B,2S,12]
    # nullspace via the smallest right singular vector
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    P = vt[:, -1].reshape(B, 3, 4)
    # fix scale/sign: det(M) > 0 and ||rows|| ~ 1
    sign = torch.where(torch.linalg.det(P[:, :, :3]) < 0, -1.0, 1.0)
    P = P * sign[:, None, None]
    scale = torch.pow(torch.clamp(torch.linalg.det(P[:, :, :3]), min=1e-12),
                      1.0 / 3.0)
    P = P / torch.clamp(scale, min=1e-12)[:, None, None]
    # orthogonalize M -> nearest rotation (SVD)
    U, _, Vt = torch.linalg.svd(P[:, :, :3])
    R = U @ Vt
    R = R * torch.sign(torch.linalg.det(R))[:, None, None]
    t = P[:, :, 3]
    ok = torch.isfinite(R).flatten(1).all(1) & torch.isfinite(t).all(1)
    return R, t, ok


def _reproj_errors(R, t, pts2d_n, pts3d):
    """Normalized reprojection error of every point under each pose:
    R [...,3,3], t [...,3] -> [..., M]; inf behind the camera."""
    cam = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    z = cam[..., 2]
    zs = torch.where(torch.abs(z) > 1e-6, z, torch.full_like(z, 1e-6))
    proj = cam[..., :2] / zs[..., None]
    err = torch.linalg.norm(proj - pts2d_n, dim=-1)
    return torch.where(z > 0.01, err, torch.full_like(err, float("inf")))


def _residual(xi, R, t, pts2d_n, pts3d, weights):
    """Weighted reprojection residual [2M] of the pose se3_exp(xi) (R, t)."""
    T = transforms.se3_exp(xi)
    Rr = T[:3, :3] @ R
    tr = T[:3, :3] @ t + T[:3, 3]
    cam = pts3d @ Rr.T + tr
    z = torch.clamp(cam[:, 2], min=1e-6)
    proj = cam[:, :2] / z[:, None]
    return ((proj - pts2d_n) * weights[:, None]).reshape(-1)


_jac = vmap(jacfwd(_residual), in_dims=(0, 0, 0, None, None, 0))
_res = vmap(_residual, in_dims=(0, 0, 0, None, None, 0))


def _gauss_newton_refine(R, t, pts2d_n, pts3d, weights, iters: int = 10):
    """Masked Gauss-Newton on the reprojection residual in an SE(3) twist,
    batched: R [B,3,3], t [B,3], weights [B,M]. Each step linearises at the
    current twist (forward-mode Jacobian: 6 tangents, O(M) each)."""
    B = R.shape[0]
    eye = 1e-8 * torch.eye(6, dtype=R.dtype, device=R.device)
    xi = R.new_zeros((B, 6))
    for _ in range(iters):
        J = _jac(xi, R, t, pts2d_n, pts3d, weights)          # [B, 2M, 6]
        r = _res(xi, R, t, pts2d_n, pts3d, weights)          # [B, 2M]
        JT = J.transpose(1, 2)
        JTJ = JT @ J + eye
        g = (JT @ r[..., None])[..., 0]
        # solve_ex: no error check, so no host sync (a failed solve gives
        # non-finite values, as jnp.linalg.solve does, and the hypothesis
        # scores -1)
        dx = torch.linalg.solve_ex(JTJ, g).result
        xi = xi - dx
    T = transforms.se3_exp(xi)
    Rt = T[:, :3, :3]
    return Rt @ R, (Rt @ t[..., None])[..., 0] + T[:, :3, 3]


def gauss_newton_fit_plain(R, t, pts2d_n, pts3d, valid, thresh: float,
                           iters: int, ok=None, best=None):
    """The plain version of ``gauss_newton_fit``, the same function in
    PyTorch: ``_gauss_newton_refine`` on the weights the kernel builds,
    then the kernel's scoring."""
    if best is None:
        err = _reproj_errors(R, t, pts2d_n, pts3d)           # [B, M]
        w = ((err < 3.0 * thresh) & valid).to(torch.float32)
        R, t = _gauss_newton_refine(R, t, pts2d_n, pts3d, w, iters)
        err = _reproj_errors(R, t, pts2d_n, pts3d)
        inl = (err < thresh) & valid
        score = torch.where(ok & torch.isfinite(t).all(1), inl.sum(1),
                            torch.full_like(inl.sum(1), -1))
        return R, t, score
    R, t = R[best:best + 1], t[best:best + 1]
    err = _reproj_errors(R, t, pts2d_n, pts3d)
    w = ((err < thresh) & valid).to(torch.float32)
    R, t = _gauss_newton_refine(R, t, pts2d_n, pts3d, w, iters)
    err2 = _reproj_errors(R, t, pts2d_n, pts3d)
    inl2 = ((err2 < thresh) & valid)[0]
    return R, t, inl2, inl2.sum()


def _check_fit_inputs(R, t, pts2d_n, pts3d, valid, ok, best):
    if (ok is None) == (best is None):
        raise ValueError("pass either ok (fit every pose) or best (fit "
                         "the pose it indexes)")
    B, M = R.shape[0], pts3d.shape[0]
    want = {"R": (R, torch.float32, (B, 3, 3)),
            "t": (t, torch.float32, (B, 3)),
            "pts2d_n": (pts2d_n, torch.float32, (M, 2)),
            "pts3d": (pts3d, torch.float32, (M, 3)),
            "valid": (valid, torch.bool, (M,))}
    if ok is not None:
        want["ok"] = (ok, torch.bool, (B,))
    else:
        want["best"] = (best, torch.int64, ())
    if B < 1:
        raise ValueError("R holds no pose")
    for name, (x, dtype, shape) in want.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != R.device:
            raise ValueError(f"{name} is on {x.device}, R on {R.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


_FIT_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int]
                 + [ctypes.c_void_p] * 6)


def _fit_lib():
    lib = build.load("pnp_refine")
    lib.pnp_refine_launch.argtypes = _FIT_ARGTYPES
    lib.pnp_refine_launch.restype = ctypes.c_int
    return lib


def _ptr(x) -> int | None:
    return None if x is None else x.data_ptr()


def gauss_newton_fit(R, t, pts2d_n, pts3d, valid, thresh: float,
                     iters: int, ok=None, best=None):
    """Gauss-Newton fits of poses R [B,3,3], t [B,3] (world to camera) to
    the pairs pts2d_n [M,2] (normalized) and pts3d [M,3] where ``valid``
    [M], ``iters`` iterations each, in an SE(3) twist.

    With ``ok`` [B] (the DLT's flags): every pose, on the pairs within
    3 ``thresh`` of its own reprojection. Returns the fitted (R, t) and
    each fit's score [B] int64: its inliers (valid pairs within ``thresh``)
    where ``ok`` and t is finite, else -1.
    With ``best`` (an int64 index on the device, e.g. ``argmax`` of the
    scores): pose ``best`` alone, on its inliers. Returns the fitted
    (R [1,3,3], t [1,3]), its inliers [M] and their count (int64, 0-d).

    On CUDA tensors it launches ``csrc/pnp_refine.cu`` once on the current
    stream, without waiting for the device, and adds one to
    ``gauss_newton_fit.launches``; on CPU tensors it runs
    ``gauss_newton_fit_plain``. Another device, a wrong dtype or shape, a
    non-contiguous tensor, or both or neither of ``ok`` and ``best``
    raise."""
    _check_fit_inputs(R, t, pts2d_n, pts3d, valid, ok, best)
    dev = R.device
    if dev.type == "cpu":
        return gauss_newton_fit_plain(R, t, pts2d_n, pts3d, valid, thresh,
                                      iters, ok=ok, best=best)
    if dev.type != "cuda":
        raise ValueError(f"gauss_newton_fit runs on cuda or cpu, not {dev}")
    B, M = R.shape[0], pts3d.shape[0]
    n_out = B if best is None else 1
    R_out = R.new_empty((n_out, 3, 3))
    t_out = t.new_empty((n_out, 3))
    score = inl = count = None
    if best is None:
        score = R.new_empty((B,), dtype=torch.int64)
    else:
        inl = valid.new_empty((M,))
        count = R.new_empty((), dtype=torch.int64)
    # the band of the loose weights, rounded to float32 as the plain
    # version's comparison rounds it
    weight_thresh = 3.0 * thresh if best is None else thresh
    lib = _fit_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pnp_refine_launch(
            R.data_ptr(), t.data_ptr(), _ptr(ok), _ptr(best), B,
            pts2d_n.data_ptr(), pts3d.data_ptr(), valid.data_ptr(), M,
            weight_thresh, thresh, iters, R_out.data_ptr(), t_out.data_ptr(),
            _ptr(score), _ptr(inl), _ptr(count), stream)
    if err != 0:
        raise RuntimeError(f"pnp_refine launch failed: CUDA error {err}")
    gauss_newton_fit.launches += 1
    if best is None:
        return R_out, t_out, score
    return R_out, t_out, inl, count


gauss_newton_fit.launches = 0


def _hypotheses(pts2d_n, pts3d, valid, priorities, sample_size: int):
    """The DLT pose (R, t contiguous, ok) of each hypothesis' sample: its
    ``sample_size`` highest-priority valid points."""
    pri = priorities + torch.where(valid, 0.0, -10.0)
    idx = torch.topk(pri, sample_size, dim=1).indices        # [B, S]
    R, t, ok = _dlt_pose(pts2d_n[idx], pts3d[idx])
    return R, t.contiguous(), ok


@full_float32()
def _solve_core(pts2d_n, pts3d, valid, priorities, inlier_thresh_n: float,
                sample_size: int, refine_iters: int):
    """RANSAC over ``priorities`` [n_hypotheses, M] (one uniform draw per
    hypothesis and point). Returns (R, t, inliers [M], count, the winning
    hypothesis' index), on the device."""
    with span("pnp.hypotheses"):
        R, t, ok = _hypotheses(pts2d_n, pts3d, valid, priorities,
                               sample_size)
    # near-minimal DLT amplifies pixel noise badly, so refine EVERY
    # hypothesis on its loose-inlier support, then score the refined pose
    # at the true threshold
    with span("pnp.refine_hypotheses"):
        R, t, score = gauss_newton_fit(R, t, pts2d_n, pts3d, valid,
                                       inlier_thresh_n, 5, ok=ok)
    with span("pnp.score"):
        best = torch.argmax(score)
    # final local optimization on the winner's strict inliers
    with span("pnp.refine_final"):
        R, t, inl, count = gauss_newton_fit(R, t, pts2d_n, pts3d, valid,
                                            inlier_thresh_n, refine_iters,
                                            best=best)
    return R[0], t[0], inl, count, best


def ransac_inputs(pts2d: np.ndarray, pts3d: np.ndarray, K: np.ndarray,
                  inlier_px: float, n_hypotheses: int, seed: int,
                  priorities, device):
    """``_solve_core``'s inputs on ``device``: the normalized pairs, their
    validity, the draws (``priorities``, or drawn from ``seed``) and the
    threshold in normalized units."""
    M = pts2d.shape[0]
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    pts2d_n = np.stack([(pts2d[:, 0] - cx) / fx,
                        (pts2d[:, 1] - cy) / fy], axis=-1).astype(np.float32)
    thresh_n = float(np.float32(inlier_px / float((fx + fy) / 2)))
    valid = np.isfinite(pts2d_n).all(-1) & np.isfinite(pts3d).all(-1)
    if priorities is None:
        gen = torch.Generator(device=device).manual_seed(seed)
        priorities = torch.rand((n_hypotheses, M), generator=gen,
                                device=device)
    return (torch.as_tensor(pts2d_n, device=device),
            torch.as_tensor(np.ascontiguousarray(pts3d, np.float32),
                            device=device),
            torch.as_tensor(valid, device=device),
            torch.as_tensor(priorities, dtype=torch.float32, device=device),
            thresh_n)


def solve_pnp_ransac(pts2d: np.ndarray, pts3d: np.ndarray, K: np.ndarray,
                     inlier_px: float = 12.0, n_hypotheses: int = 1024,
                     sample_size: int = 6, refine_iters: int = 10,
                     min_inliers: int = 5, seed: int = 0,
                     priorities: torch.Tensor | np.ndarray | None = None,
                     device="cuda"):
    """pts2d [M,2] pixel coords (x=u, y=v), pts3d [M,3] world.

    ``priorities`` [n_hypotheses, M] replaces the draw from ``seed``.
    Returns dict {success, r (c2w R), t (c2w t), num_inliers, inliers} with
    the reference solve_pose output convention (test.py:64-84; the
    reference defines ransac_thresh=12 px, which is applied here).
    """
    M = pts2d.shape[0]
    if M < sample_size:
        return {"success": False, "r": None, "t": None,
                "num_inliers": 0, "inliers": np.zeros((M,), bool)}
    R, t, inl, n_inl, _ = _solve_core(
        *ransac_inputs(pts2d, pts3d, K, inlier_px, n_hypotheses, seed,
                       priorities, device),
        sample_size, refine_iters)
    # the host's first wait on the device's PnP work
    with span("pnp.readback"):
        n_inl = int(n_inl)
        inl = inl.cpu().numpy()
        if n_inl >= min_inliers:
            Rw2c = R.cpu().numpy()
            tw2c = t.cpu().numpy()
    if n_inl < min_inliers:
        return {"success": False, "r": None, "t": None,
                "num_inliers": n_inl, "inliers": inl}
    # w2c -> c2w like the reference
    Rc2w = Rw2c.T
    tc2w = -Rc2w @ tw2c
    return {"success": True, "r": Rc2w, "t": tc2w,
            "num_inliers": n_inl, "inliers": inl}
