"""GaussianScene: the scene state as padded-capacity tensors.

Port of ``splatloc_tpu.scene.gaussians`` (fields, activations and the
parameter split). A fixed-capacity struct of tensors with an ``alive`` mask;
parameter semantics match the reference:
- xyz [M,3]; f_dc [M,1,3], f_rest [M,R,3] SH coefficients (R=(deg+1)^2-1)
- scaling [M,3] log-scale (activation exp); rotation [M,4] quat wxyz
- opacity [M,1] logit (activation sigmoid)
- marker [M,1]: SuperPoint saliency lifted at init, never trained
- kp_score [M,1]: learned raw logit rasterized as the 4th channel
New Gaussians go into free slots (``free_slots``, ``slots_for``,
``insert``), compactly and without a host sync.
"""
from __future__ import annotations

import dataclasses

import torch

from splatloc_tpu_torch.core import transforms


def set_rows(a: torch.Tensor, idx: torch.Tensor, value) -> torch.Tensor:
    """``a`` with rows ``idx`` set to ``value`` (a scalar or one row per
    index); indices at or past the end are dropped, as the JAX package's
    ``.at[idx].set(..., mode="drop")`` drops them. The dropped rows land on
    a scratch row that is cut off, so kept indices, which are unique, get
    their values whatever the order of the writes."""
    n = a.shape[0]
    ext = torch.cat([a, a.new_zeros((1,) + a.shape[1:])])
    ext[torch.clamp(idx.long(), max=n)] = value
    return ext[:n]


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

    # ---- slot management ---------------------------------------------

    def free_slots(self, budget: int) -> torch.Tensor:
        """Indices of up to ``budget`` free slots, in index order (filled
        with capacity as an out-of-range sentinel)."""
        mask = ~self.alive
        pos = torch.cumsum(mask, 0) - 1
        dst = torch.where(mask & (pos < budget), pos,
                          torch.full_like(pos, budget))
        slots = torch.full((budget + 1,), self.capacity, dtype=torch.int32,
                           device=mask.device)
        slots.scatter_(0, dst, torch.arange(self.capacity, dtype=torch.int32,
                                            device=mask.device))
        return slots[:budget]

    def slots_for(self, valid_new: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
        """Compactly assign free slots to the VALID entries of a budget-B
        batch: the r-th valid entry gets the r-th free slot, so invalid
        entries never waste slots (correct even when B > free capacity).

        Returns (dst [B] int32 with the capacity as sentinel for dropped
        entries, ok [B])."""
        B = valid_new.shape[0]
        slots = self.free_slots(B)
        rank = torch.cumsum(valid_new, 0) - 1
        entry_slot = slots[torch.clamp(rank, 0, B - 1)]
        ok = valid_new & (entry_slot < self.capacity)
        dst = torch.where(ok, entry_slot,
                          torch.full_like(entry_slot, self.capacity))
        return dst, ok

    def insert(self, values: dict, valid_new: torch.Tensor
               ) -> "GaussianScene":
        """Scatter new Gaussians into free slots: ``values`` holds
        PARAM_FIELDS tensors with leading dim B, ``valid_new`` [B] bool.
        Points beyond the free capacity are dropped."""
        dst, _ = self.slots_for(valid_new)
        new = {k: set_rows(getattr(self, k), dst, values[k])
               for k in self.PARAM_FIELDS}
        return self.replace(alive=set_rows(self.alive, dst, True), **new)
