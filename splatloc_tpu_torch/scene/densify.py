"""Adaptive density control on padded buffers.

Port of ``splatloc_tpu.scene.densify``: the reference densify/clone/split/
prune pipeline (gaussian_model.py:590-679) and opacity resets (:384-392)
with static shapes. Candidate selection uses fixed budgets (cumsum
compaction), new Gaussians go into free slots, pruning clears the alive
mask; the reference's Adam tensor surgery becomes optim.zero_slots on the
touched rows. Nothing here syncs with the host.

The split children's normal draws come from a ``torch.Generator`` (JAX's
streams cannot be reproduced in torch) or, for tests, from ``split_normals``
[2, split_budget, 3].
"""
from __future__ import annotations

import dataclasses
import math

import torch

from splatloc_tpu_torch.core import transforms
from splatloc_tpu_torch.scene import optim
from splatloc_tpu_torch.scene.gaussians import GaussianScene, set_rows


@dataclasses.dataclass(frozen=True)
class DensifyStats:
    """Running densification statistics (reference gaussian_model.py:251-
    253, 677-679): accumulated screen-space gradient norm and visit counts,
    plus max screen radius."""
    xyz_gradient_accum: torch.Tensor   # [M]
    denom: torch.Tensor                # [M]
    max_radii2d: torch.Tensor          # [M] float (pixels)

    @classmethod
    def zeros(cls, capacity: int, device="cuda") -> "DensifyStats":
        z = torch.zeros((capacity,), dtype=torch.float32, device=device)
        return cls(xyz_gradient_accum=z, denom=z, max_radii2d=z)

    def replace(self, **changes) -> "DensifyStats":
        return dataclasses.replace(self, **changes)


def add_stats(stats: DensifyStats, means2d_grad: torch.Tensor,
              radii: torch.Tensor, width: int, height: int) -> DensifyStats:
    """Accumulate ||grad_means2D|| for visible Gaussians.

    means2d_grad is in pixel units; the reference accumulates it in NDC
    units (pixel grad x W/2, H/2) against threshold 0.0002, so it is
    rescaled to match the calibrated threshold."""
    visible = radii > 0
    g = torch.stack([means2d_grad[:, 0] * (0.5 * width),
                     means2d_grad[:, 1] * (0.5 * height)], dim=-1)
    norm = torch.linalg.norm(g, dim=-1)
    zero = torch.zeros_like(norm)
    return stats.replace(
        xyz_gradient_accum=stats.xyz_gradient_accum
        + torch.where(visible, norm, zero),
        denom=stats.denom + visible.to(torch.float32),
        max_radii2d=torch.maximum(stats.max_radii2d, torch.where(
            visible, radii.to(torch.float32), zero)),
    )


def _select(mask: torch.Tensor, budget: int) -> torch.Tensor:
    """First ``budget`` indices where mask (in index order, like the
    reference's boolean indexing); the sentinel len(mask) fills the rest."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, 0) - 1
    dst = torch.where(mask & (pos < budget), pos,
                      torch.full_like(pos, budget))
    out = torch.full((budget + 1,), n, dtype=torch.int32, device=mask.device)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int32,
                                      device=mask.device))
    return out[:budget]


def _gather_params(scene: GaussianScene, idx: torch.Tensor) -> dict:
    """Param rows at idx (sentinel rows repeat the last slot; the caller's
    valid flags mask them)."""
    safe = torch.clamp(idx, max=scene.capacity - 1).long()
    return {k: getattr(scene, k)[safe] for k in scene.PARAM_FIELDS}


def _insert_with_state(scene, opt_state, vals, valid):
    """Insert rows into free slots and zero their Adam state."""
    dst, ok = scene.slots_for(valid)
    new = {k: set_rows(getattr(scene, k), dst, vals[k])
           for k in scene.PARAM_FIELDS}
    scene = scene.replace(alive=set_rows(scene.alive, dst, True), **new)
    return scene, optim.zero_slots(opt_state, dst), ok


def densify_and_prune(
    scene: GaussianScene,
    stats: DensifyStats,
    opt_state: optim.AdamState,
    generator: torch.Generator | None = None,
    *,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float | None,
    percent_dense: float,
    primitive_reg: bool,
    marker_thresh: float = 0.005,
    clone_budget: int = 4096,
    split_budget: int = 4096,
    split_normals: torch.Tensor | None = None,
):
    """Clone + split + prune (reference gaussian_model.py:657-675 order:
    clone, split (N=2, prune originals), then opacity/size prune with
    key-primitive protection). Returns (scene, stats, opt_state, info)."""
    grads = torch.where(stats.denom > 0,
                        stats.xyz_gradient_accum / stats.denom,
                        torch.zeros_like(stats.denom))
    max_scale = torch.amax(scene.scaling_activated(), dim=-1)
    hi_grad = (grads >= max_grad) & scene.alive

    # clone: small gaussians copied verbatim (gaussian_model.py:632-655)
    clone_mask = hi_grad & (max_scale <= percent_dense * extent)
    clone_idx = _select(clone_mask, clone_budget)
    clone_valid = clone_idx < scene.capacity
    clone_vals = _gather_params(scene, clone_idx)

    # split: large gaussians -> 2 children sampled from N(0, scale), rotated
    # into world, scale shrunk by 0.8*N (gaussian_model.py:590-630)
    split_mask = hi_grad & (max_scale > percent_dense * extent)
    split_idx = _select(split_mask, split_budget)
    split_valid = split_idx < scene.capacity
    parent = _gather_params(scene, split_idx)
    std = torch.exp(parent["scaling"])                       # [B,3]
    if split_normals is None:
        split_normals = torch.randn((2, split_budget, 3),
                                    generator=generator,
                                    device=std.device)
    R = transforms.quat_to_matrix(parent["rotation"])        # [B,3,3]
    child_vals = []
    for i in range(2):
        offs = torch.einsum("bij,bj->bi", R, split_normals[i] * std)
        vals = dict(parent)
        vals["xyz"] = parent["xyz"] + offs
        vals["scaling"] = torch.log(torch.clamp(std / (0.8 * 2),
                                                min=1e-12))
        child_vals.append(vals)

    # insert clones then children; zero Adam state at the new slots
    scene, opt_state, clone_ok = _insert_with_state(scene, opt_state,
                                                    clone_vals, clone_valid)
    scene, opt_state, s0_ok = _insert_with_state(scene, opt_state,
                                                 child_vals[0], split_valid)
    scene, opt_state, s1_ok = _insert_with_state(scene, opt_state,
                                                 child_vals[1], split_valid)

    # split originals are pruned, but only parents whose children both fit
    parents_split = set_rows(
        torch.zeros_like(split_mask),
        torch.where(s0_ok & s1_ok, split_idx,
                    torch.full_like(split_idx, scene.capacity)), True)

    # prune (on the post-insert state, like the reference)
    prune = scene.opacity_activated() < min_opacity
    if max_screen_size is not None:
        big_vs = stats.max_radii2d > max_screen_size
        big_ws = torch.amax(scene.scaling_activated(), dim=-1) > 0.1 * extent
        prune = prune | big_vs | big_ws
    if primitive_reg:
        prune = prune & (scene.marker[:, 0] <= marker_thresh)
    prune = (prune | parents_split) & scene.alive

    scene = scene.replace(alive=scene.alive & ~prune)

    # reset running stats (reference densification_postfix zeroes them)
    stats = DensifyStats.zeros(scene.capacity, device=scene.xyz.device)
    info = {"n_cloned": torch.sum(clone_ok),
            "n_split": torch.sum(s0_ok) + torch.sum(s1_ok),
            "n_pruned": torch.sum(prune)}
    return scene, stats, opt_state, info


def reset_opacity_nonvisible(scene: GaussianScene,
                             opt_state: optim.AdamState,
                             visible_union: torch.Tensor,
                             value: float = 0.4):
    """Reset opacity of non-visible Gaussians to ``value`` (reference
    gaussian_model.py:384-392) and clear the opacity Adam state (the
    replace_tensor_to_optimizer side effect)."""
    # rounded once from float64, as the JAX package's constant is
    logit = torch.full_like(scene.opacity, math.log(value / (1.0 - value)))
    new_op = torch.where((~visible_union & scene.alive)[:, None], logit,
                         scene.opacity)
    return (scene.replace(opacity=new_op),
            optim.zero_field(opt_state, "opacity"))
