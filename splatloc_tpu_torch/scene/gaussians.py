"""GaussianScene: the scene state as padded-capacity tensors.

Port of ``splatloc_tpu.scene.gaussians`` (fields, activations and the
parameter split). A fixed-capacity struct of tensors with an ``alive`` mask;
parameter semantics match the reference:
- xyz [M,3]; f_dc [M,1,3], f_rest [M,R,3] SH coefficients (R=(deg+1)^2-1)
- scaling [M,3] log-scale (activation exp); rotation [M,4] quat wxyz
- opacity [M,1] logit (activation sigmoid)
- marker [M,1]: SuperPoint saliency lifted at init, never trained
- kp_score [M,1]: learned raw logit rasterized as the 4th channel
Slot management (free slots, insertion) belongs to mapping and is not
ported yet.
"""
from __future__ import annotations

import dataclasses

import torch

from splatloc_tpu_torch.core import transforms


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    xyz: torch.Tensor         # [M,3]
    f_dc: torch.Tensor        # [M,1,3]
    f_rest: torch.Tensor      # [M,R,3]
    scaling: torch.Tensor     # [M,3] (log)
    rotation: torch.Tensor    # [M,4]
    opacity: torch.Tensor     # [M,1] (logit)
    marker: torch.Tensor      # [M,1]
    kp_score: torch.Tensor    # [M,1]
    alive: torch.Tensor       # [M] bool
    sh_degree: int = 0

    PARAM_FIELDS = ("xyz", "f_dc", "f_rest", "opacity", "marker", "kp_score",
                    "scaling", "rotation")

    # ---- constructors -------------------------------------------------

    @classmethod
    def empty(cls, capacity: int, sh_degree: int = 0,
              device="cuda") -> "GaussianScene":
        r = (sh_degree + 1) ** 2 - 1
        kw = dict(dtype=torch.float32, device=device)
        return cls(
            xyz=torch.zeros((capacity, 3), **kw),
            f_dc=torch.zeros((capacity, 1, 3), **kw),
            f_rest=torch.zeros((capacity, r, 3), **kw),
            scaling=torch.full((capacity, 3), -10.0, **kw),
            rotation=torch.tensor([[1.0, 0, 0, 0]], **kw).repeat(capacity, 1),
            opacity=torch.full((capacity, 1), -10.0, **kw),
            marker=torch.zeros((capacity, 1), **kw),
            kp_score=torch.zeros((capacity, 1), **kw),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=device),
            sh_degree=sh_degree,
        )

    def replace(self, **changes) -> "GaussianScene":
        return dataclasses.replace(self, **changes)

    # ---- views --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    def scaling_activated(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    def opacity_activated(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity[:, 0])

    def rotation_activated(self) -> torch.Tensor:
        return transforms.quat_normalize(self.rotation)

    def features(self) -> torch.Tensor:
        """[M, 3, (deg+1)^2] SH coefficient layout for eval_sh."""
        cat = torch.cat([self.f_dc, self.f_rest], dim=1)  # [M, 1+R, 3]
        return cat.transpose(1, 2)

    def covariance(self, scaling_modifier: float = 1.0) -> torch.Tensor:
        """[M,3,3] world covariance."""
        from splatloc_tpu_torch.raster.project import build_cov3d
        return build_cov3d(self.scaling_activated() * scaling_modifier,
                           self.rotation)

    # ---- params split for the optimizer ------------------------------

    def params(self) -> dict:
        return {k: getattr(self, k) for k in self.PARAM_FIELDS}

    def with_params(self, params: dict) -> "GaussianScene":
        return self.replace(**params)
