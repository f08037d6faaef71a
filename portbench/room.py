"""Procedural rooms: a configuration's scene box with box furniture inside,
textured smoothly, made from a seed and ray-cast on the device.

This is the benchmark's own input generator: RGB-D keyframes, score maps,
database depth maps and points on the surfaces all come from here, and both
the program and the plain reference get the same arrays.

Camera convention: OpenCV (x right, y down, z forward). A pixel (i, j) is
the ray through x/z = (i + 0.5 - cx) / fx, y/z = (j + 0.5 - cy) / fy, so a
ray-cast depth at (i, j) is what the port's integer-centre projection and
the raw-K projection (u = fx x/z + cx, pixel int(u)) both read there.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Room:
    lo: np.ndarray          # [3] box corner (float64)
    hi: np.ndarray          # [3]
    up: int                 # vertical axis: the box's smallest extent
    a: int                  # longest horizontal axis
    b: int                  # the other horizontal axis
    furn_lo: np.ndarray     # [F, 3]
    furn_hi: np.ndarray     # [F, 3]
    freq: np.ndarray        # [S, 3, 3] texture frequencies per surface
    phase: np.ndarray       # [S, 3]

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.lo + self.hi)

    @property
    def extent(self) -> np.ndarray:
        return self.hi - self.lo


def _basis(room: Room):
    e = np.eye(3)
    return e[room.a], e[room.b], e[room.up]


def look_pose(room: Room, center: np.ndarray, yaw: float) -> np.ndarray:
    """World-to-camera [4,4] float32 of a level camera at ``center``
    looking along cos(yaw) e_a + sin(yaw) e_b."""
    ea, eb, eu = _basis(room)
    fwd = np.cos(yaw) * ea + np.sin(yaw) * eb
    down = -eu
    right = np.cross(down, fwd)
    c2w = np.eye(4)
    c2w[:3, :3] = np.stack([right, down, fwd], -1)
    c2w[:3, 3] = center
    return np.linalg.inv(c2w).astype(np.float32)


def keyframe_poses(room: Room, n: int) -> np.ndarray:
    """The mapping orbit: ``tools/quality_gate.py``'s sweep of 0.9 rad of
    yaw with a sideways and vertical sway, set back along the room's long
    axis so each view sees the far wall and the furniture."""
    ea, eb, eu = _basis(room)
    L = room.extent
    poses = []
    for i in range(n):
        ang = 0.9 * (i / max(n - 1, 1) - 0.5)
        c = (room.center - 0.3 * L[room.a] * ea
             + 0.2 * L[room.b] * (ang / 0.45) * eb
             + 0.05 * L[room.up] * np.sin(3 * ang) * eu)
        poses.append(look_pose(room, c, ang))
    return np.stack(poses)


def database_poses(room: Room, n: int) -> np.ndarray:
    """A ring of ``n`` views near the room's centre, each looking outward
    at yaw 2 pi i / n."""
    ea, eb, eu = _basis(room)
    L = room.extent
    poses = []
    for i in range(n):
        phi = 2 * np.pi * i / n
        c = (room.center + 0.12 * L[room.a] * np.cos(phi) * ea
             + 0.12 * L[room.b] * np.sin(phi) * eb
             + 0.05 * L[room.up] * np.sin(2 * phi) * eu)
        poses.append(look_pose(room, c, phi))
    return np.stack(poses)


def perturb_pose(w2c: np.ndarray, rng: np.random.Generator,
                 trans_m: tuple, rot_deg: tuple) -> np.ndarray:
    """``w2c`` moved by a random translation of length in ``trans_m`` and a
    rotation about a random axis by an angle in ``rot_deg``."""
    c2w = np.linalg.inv(w2c.astype(np.float64))
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    ang = np.radians(rng.uniform(*rot_deg))
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * (k @ k)
    out = c2w.copy()
    out[:3, :3] = R @ c2w[:3, :3]
    out[:3, 3] = c2w[:3, 3] + rng.uniform(*trans_m) * d
    return np.linalg.inv(out).astype(np.float32)


def make_room(bound, layout_seed: int, n_furniture: int,
              keep_clear: np.ndarray, texture_seed: int = 0) -> Room:
    """The box ``bound`` ([[lo, hi]] x 3) with ``n_furniture`` boxes
    standing on its floor, none within 0.4 m of a point of ``keep_clear``
    [P, 3] (the camera centres), placed from ``layout_seed``, and a smooth
    texture per surface drawn from ``texture_seed``."""
    rng = np.random.default_rng([layout_seed, 7])
    lo = np.array([b[0] for b in bound], np.float64)
    hi = np.array([b[1] for b in bound], np.float64)
    ext = hi - lo
    up = int(np.argmin(ext))
    a, b = sorted((i for i in range(3) if i != up), key=lambda i: -ext[i])
    flo, fhi = [], []
    tries = 0
    while len(flo) < n_furniture and tries < 10_000:
        tries += 1
        size = np.empty(3)
        size[a] = rng.uniform(0.08, 0.2) * ext[a]
        size[b] = rng.uniform(0.08, 0.2) * ext[b]
        size[up] = rng.uniform(0.25, 0.6) * ext[up]
        c_lo = lo + 0.02 * ext
        c_hi = hi - size - 0.02 * ext
        c_lo[up], c_hi[up] = lo[up], lo[up]
        f_lo = rng.uniform(c_lo, np.maximum(c_hi, c_lo))
        f_hi = f_lo + size
        near = np.all((keep_clear > f_lo - 0.4) & (keep_clear < f_hi + 0.4),
                      axis=-1)
        if near.any():
            continue
        flo.append(f_lo)
        fhi.append(f_hi)
    n_s = 6 + 6 * len(flo)
    rng = np.random.default_rng([texture_seed, 8])
    return Room(lo=lo, hi=hi, up=up, a=a, b=b,
                furn_lo=np.array(flo).reshape(-1, 3),
                furn_hi=np.array(fhi).reshape(-1, 3),
                freq=rng.uniform(0.8, 6.0, (n_s, 3, 3)),
                phase=rng.uniform(0, 2 * np.pi, (n_s, 3)))


def texture(room: Room, p: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """RGB in [0.05, 0.95] at points ``p`` [..., 3] of surfaces ``sid``."""
    dev = p.device
    freq = torch.as_tensor(room.freq, dtype=torch.float32, device=dev)[sid]
    phase = torch.as_tensor(room.phase, dtype=torch.float32,
                            device=dev)[sid]
    arg = torch.einsum("...cj,...j->...c", freq, p) + phase
    return 0.5 + 0.45 * torch.sin(arg)


def raycast(room: Room, w2c: np.ndarray, fx: float, fy: float, cx: float,
            cy: float, width: int, height: int, device):
    """(rgb [H,W,3], depth [H,W], sid [H,W]) of the view ``w2c``: the
    nearest hit of each pixel's ray on the room's walls or furniture."""
    f32 = dict(dtype=torch.float32, device=device)
    c2w = np.linalg.inv(w2c.astype(np.float64))
    R = torch.as_tensor(c2w[:3, :3], **f32)
    o = torch.as_tensor(c2w[:3, 3], **f32)
    j, i = torch.meshgrid(torch.arange(height, **f32),
                          torch.arange(width, **f32), indexing="ij")
    d_cam = torch.stack([(i + 0.5 - cx) / fx, (j + 0.5 - cy) / fy,
                         torch.ones_like(i)], -1)
    d = d_cam @ R.T                                     # [H,W,3], z_cam = 1
    safe = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    lo = torch.as_tensor(room.lo, **f32)
    hi = torch.as_tensor(room.hi, **f32)
    # inside the room: the first wall each ray leaves through
    t_wall = torch.where(safe > 0, (hi - o) / safe, (lo - o) / safe)
    t, axis = torch.min(t_wall, dim=-1)
    side = torch.gather((safe > 0).long(), -1, axis[..., None])[..., 0]
    sid = axis * 2 + side
    for f in range(len(room.furn_lo)):
        flo = torch.as_tensor(room.furn_lo[f], **f32)
        fhi = torch.as_tensor(room.furn_hi[f], **f32)
        t1 = (flo - o) / safe
        t2 = (fhi - o) / safe
        tn, an = torch.max(torch.minimum(t1, t2), dim=-1)
        tf = torch.min(torch.maximum(t1, t2), dim=-1).values
        hit = (tn < tf) & (tn > 0) & (tn < t)
        fside = torch.gather((safe < 0).long(), -1, an[..., None])[..., 0]
        t = torch.where(hit, tn, t)
        sid = torch.where(hit, 6 + 6 * f + an * 2 + fside, sid)
    p = o + t[..., None] * d
    return texture(room, p, sid), t, sid


def surface_points(room: Room, n: int, gen: torch.Generator, device):
    """``n`` points uniform by area on the walls and the furniture's faces
    (furniture floors left out), with their surface ids."""
    rects = []                      # (axis, coordinate, lo [3], hi [3], sid)
    for ax in range(3):
        for side, c in ((0, room.lo[ax]), (1, room.hi[ax])):
            rects.append((ax, c, room.lo, room.hi, ax * 2 + side))
    for f, (flo, fhi) in enumerate(zip(room.furn_lo, room.furn_hi)):
        for ax in range(3):
            for side, c in ((0, flo[ax]), (1, fhi[ax])):
                if ax == room.up and side == 0:
                    continue
                rects.append((ax, c, flo, fhi, 6 + 6 * f + ax * 2 + side))
    area = np.array([np.prod(np.delete(h - l, ax)) for ax, _, l, h, _
                     in rects])
    f32 = dict(dtype=torch.float32, device=device)
    which = torch.multinomial(torch.as_tensor(area / area.sum(), **f32), n,
                              replacement=True, generator=gen)
    lo = torch.as_tensor(np.stack([r[2] for r in rects]), **f32)[which]
    hi = torch.as_tensor(np.stack([r[3] for r in rects]), **f32)[which]
    u = torch.rand((n, 3), generator=gen, **f32)
    p = lo + u * (hi - lo)
    ax = torch.as_tensor([r[0] for r in rects], device=device)[which]
    coord = torch.as_tensor([r[1] for r in rects], **f32)[which]
    p = torch.where(torch.arange(3, device=device)[None] == ax[:, None],
                    coord[:, None], p)
    sid = torch.as_tensor([r[4] for r in rects], device=device)[which]
    return p, sid


def project_raw(pts: torch.Tensor, w2c: np.ndarray, fx, fy, cx, cy):
    """Raw-K projection u = fx x/z + cx of world points: (uv [N,2], z)."""
    W = torch.as_tensor(w2c, dtype=torch.float32, device=pts.device)
    cam = pts @ W[:3, :3].T + W[:3, 3]
    z = cam[:, 2]
    zs = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * cam[:, 0] / zs + cx,
                        fy * cam[:, 1] / zs + cy], -1), z


def visible(pts: torch.Tensor, w2c: np.ndarray, depth: torch.Tensor, fx,
            fy, cx, cy, tol: float = 0.02):
    """Which points a view sees: in front, inside the image, and within
    ``tol`` m of the ray-cast depth at their pixel. Returns (mask, uv)."""
    H, W = depth.shape
    uv, z = project_raw(pts, w2c, fx, fy, cx, cy)
    inside = (z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < W) & (
        uv[:, 1] >= 0) & (uv[:, 1] < H)
    ui = uv[:, 0].clamp(0, W - 1).long()
    vi = uv[:, 1].clamp(0, H - 1).long()
    return inside & ((depth[vi, ui] - z).abs() < tol), uv


def score_map(landmarks: torch.Tensor, w2c: np.ndarray, depth: torch.Tensor,
              fx, fy, cx, cy) -> torch.Tensor:
    """A SuperPoint-like score map [H, W]: a 5x5 blob of 0.9 exp(-r^2/2)
    around each visible landmark (``tools/quality_gate.py``'s
    ``score_map``, with occlusion)."""
    H, W = depth.shape
    vis, uv = visible(landmarks, w2c, depth, fx, fy, cx, cy)
    ui = torch.floor(uv[vis, 0]).long()
    vi = torch.floor(uv[vis, 1]).long()
    ok = (ui >= 2) & (ui < W - 2) & (vi >= 2) & (vi < H - 2)
    ui, vi = ui[ok], vi[ok]
    sc = torch.zeros(H * W, dtype=torch.float32, device=depth.device)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            val = 0.9 * float(np.exp(-(dx * dx + dy * dy) / 2.0))
            idx = (vi + dy) * W + ui + dx
            sc.scatter_reduce_(0, idx, torch.full_like(idx, 0,
                                                       dtype=torch.float32)
                               + val, reduce="amax")
    return sc.reshape(H, W)
