"""Rotation / rigid-transform math on torch tensors.

Port of ``splatloc_tpu.core.transforms``: quaternion <-> matrix, SO(3)/SE(3)
exp/log maps for 6-DoF pose refinement. Quaternion convention (w, x, y, z),
w first. All functions operate on the last axis (or the last two for
matrices) and broadcast over leading axes.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=_EPS)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w,x,y,z) -> rotation matrix [..., 3, 3]."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (w,x,y,z), choosing
    the largest-denominator branch without host control flow."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    cand0 = torch.stack([qw0, (m21 - m12) / (4 * qw0),
                         (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    cand1 = torch.stack([(m21 - m12) / s1, s1 / 4, (m01 + m10) / s1,
                         (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    cand2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, s2 / 4,
                         (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    cand3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                         (m12 + m21) / s3, s3 / 4], -1)

    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, cand0,
                    torch.where(cond1, cand1,
                                torch.where(cond2, cand2, cand3)))
    return quat_normalize(q)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], -1)


def quat_angle_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (degrees) between two unit quaternions."""
    a = quat_normalize(a)
    b = quat_normalize(b)
    dot = torch.abs(torch.sum(a * b, dim=-1))
    dot = torch.clamp(dot, -1.0, 1.0)
    return 2.0 * torch.rad2deg(torch.arccos(dot))


def rotation_6d_to_matrix(d6: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation parameterization -> matrix (Zhou et al. 2019)."""
    a1, a2 = d6[..., :3], d6[..., 3:]
    b1 = a1 / torch.clamp(torch.linalg.norm(a1, dim=-1, keepdim=True),
                          min=_EPS)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp(torch.linalg.norm(a2p, dim=-1, keepdim=True),
                           min=_EPS)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-2)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ]
    return torch.stack(rows, dim=-2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [...,3] -> rotation matrix via Rodrigues. NaN-safe under
    autograd at theta=0: the untaken branch uses a sanitized theta."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]  # [...,1,1]
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    K = skew(w) / theta
    eye = _eye_like(K)
    R = eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * (K @ K)
    return torch.where(small, eye + skew(w), R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle [...,3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((tr - 1) / 2, -1 + 1e-7, 1 - 1e-7)
    theta = torch.arccos(cos)
    v = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    scale = theta / torch.clamp(2 * torch.sin(theta), min=_EPS)
    w = scale[..., None] * v
    small = (theta < 1e-6)[..., None]
    return torch.where(small, 0.5 * v, w)


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    # made by fills on the device: a copy from a host list would wait for
    # the stream on every pose inversion of a render
    row = torch.cat([top.new_zeros((3,)), top.new_ones((1,))])
    return row.expand(top.shape[:-2] + (1, 4))


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist [...,6] (rho, omega) -> 4x4 rigid transform. The pose update
    of render-loss refinement is ``T_new = se3_exp(delta) @ T``."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    K = skew(w) / theta
    eye = _eye_like(K)
    R = so3_exp(w)
    V = (eye + (1 - torch.cos(theta)) / theta * K
         + (theta - torch.sin(theta)) / theta * (K @ K))
    V = torch.where(small, eye + 0.5 * skew(w), V)
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """4x4 rigid transform -> twist [...,6]; inverse of se3_exp."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    K = skew(w) / theta
    eye = _eye_like(K)
    half = 0.5 * theta
    cot = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    Vinv = eye - 0.5 * theta * K + (1 - cot) * (K @ K)
    Vinv = torch.where(small, eye - 0.5 * skew(w), Vinv)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 rigid transform to points [..., N, 3]."""
    return (pts @ T[..., :3, :3].transpose(-1, -2)
            + T[..., :3, 3][..., None, :])


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    return torch.cat([top, _bottom_row(top)], dim=-2)
