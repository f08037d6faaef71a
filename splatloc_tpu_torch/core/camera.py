"""Pinhole camera with a world-to-camera pose, on torch tensors.

Port of ``splatloc_tpu.core.camera``. The camera carries the raw
world-to-camera transform and pinhole intrinsics and projects directly:

    x_cam = w2c[:3,:3] @ x_world + w2c[:3,3]       (OpenCV: +z forward)
    u     = fx * x/z + (cx - 0.5)                  (pixel centers at integers)

The ``cx - 0.5`` matches the reference CUDA rasterizer's pixel grid. The
intrinsics are 0-d float32 tensors on the camera's device, so every product
with them rounds exactly as the JAX package's float32 scalars do, and the
pose stays differentiable.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from splatloc_tpu_torch.core import transforms


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Pinhole camera: ``w2c`` [4,4] and the intrinsics are float32 tensors
    on one device; ``width``/``height`` are plain ints."""
    w2c: torch.Tensor
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int
    height: int
    znear: float = 0.01
    zfar: float = 100.0

    @classmethod
    def create(cls, w2c, fx, fy, cx, cy, width, height, znear=0.01,
               zfar=100.0, device="cuda") -> "Camera":
        def f32(x):
            if isinstance(x, torch.Tensor):
                return x.to(dtype=torch.float32, device=device)
            return torch.tensor(np.asarray(x, np.float32), device=device)
        return cls(w2c=f32(w2c), fx=f32(fx), fy=f32(fy), cx=f32(cx),
                   cy=f32(cy), width=int(width), height=int(height),
                   znear=float(znear), zfar=float(zfar))

    @property
    def device(self) -> torch.device:
        return self.w2c.device

    @property
    def c2w(self) -> torch.Tensor:
        return transforms.invert_se3(self.w2c)

    @property
    def camera_center(self) -> torch.Tensor:
        """World-space camera position."""
        return self.c2w[:3, 3]

    @property
    def tanfovx(self) -> torch.Tensor:
        return (0.5 * self.width) / self.fx

    @property
    def tanfovy(self) -> torch.Tensor:
        return (0.5 * self.height) / self.fy

    @property
    def K(self) -> torch.Tensor:
        zero = torch.zeros_like(self.fx)
        one = torch.ones_like(self.fx)
        return torch.stack([torch.stack([self.fx, zero, self.cx]),
                            torch.stack([zero, self.fy, self.cy]),
                            torch.stack([zero, zero, one])])

    def replace_pose(self, w2c: torch.Tensor) -> "Camera":
        return dataclasses.replace(
            self, w2c=torch.as_tensor(w2c, dtype=torch.float32,
                                      device=self.device))

    # -- projection -----------------------------------------------------

    def project(self, pts_w: torch.Tensor):
        """World points [N,3] -> (pixel_xy [N,2], view_z [N]) on the
        rasterizer's integer-center grid."""
        p_view = pts_w @ self.w2c[:3, :3].T + self.w2c[:3, 3]
        z = p_view[..., 2]
        zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        u = self.fx * p_view[..., 0] / zs + (self.cx - 0.5)
        v = self.fy * p_view[..., 1] / zs + (self.cy - 0.5)
        return torch.stack([u, v], dim=-1), z

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor
                    ) -> torch.Tensor:
        """Pixel coords [...,2] (integer-center grid) + depth -> world
        points; inverse of :meth:`project`."""
        x = (uv[..., 0] - (self.cx - 0.5)) * depth / self.fx
        y = (uv[..., 1] - (self.cy - 0.5)) * depth / self.fy
        p_cam = torch.stack([x, y, depth], dim=-1)
        c2w = self.c2w
        return p_cam @ c2w[:3, :3].T + c2w[:3, 3]
