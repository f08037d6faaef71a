"""Keypoint-aware Gaussian initialization from an RGB-D frame.

Port of ``splatloc_tpu.scene.init_rgbd`` (reference gaussian_model.py:119-
248): keypoint pixels (SuperPoint score > 0.005, no downsampling) plus
non-keypoint pixels randomly downsampled 64x, back-projected through the
camera, colored from the exposure-corrected image, with isotropic log-scale
from the 3-NN mean squared distance times the (adaptive) point size. New
Gaussians: opacity logit 0 (sigmoid 0.5), identity rotation, marker =
score, kp_score raw 0.5. Fixed budgets, so nothing syncs with the host.

The random priorities of the non-keypoint downsampling come from a
``torch.Generator`` (JAX's streams cannot be reproduced in torch) or, for
tests, from ``priorities`` [H*W] uniform in [0, 1).
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.core import sh as sh_mod
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.knn import mean_dist2_3nn
from splatloc_tpu_torch.scene import optim
from splatloc_tpu_torch.scene.gaussians import GaussianScene, set_rows


def _select_first(mask2d: torch.Tensor, budget: int):
    """Row-major first-``budget`` selected pixel indices (the reference's
    np.argwhere order). Returns (flat_idx [B] int32, valid [B])."""
    flat = mask2d.reshape(-1)
    n = flat.shape[0]
    dev = flat.device
    pos = torch.cumsum(flat, 0) - 1
    dst = torch.where(flat & (pos < budget), pos,
                      torch.full_like(pos, budget))
    out = torch.zeros((budget + 1,), dtype=torch.int32, device=dev)
    out.scatter_(0, dst, torch.arange(n, dtype=torch.int32, device=dev))
    count = torch.clamp(torch.sum(flat), max=budget)
    valid = torch.arange(budget, device=dev) < count
    return out[:budget], valid


def _select_random(mask2d: torch.Tensor, budget: int, n_take: torch.Tensor,
                   priorities: torch.Tensor):
    """``n_take`` selected pixels chosen by the largest random priorities
    (the reference's np.random.choice downsampling, gaussian_model.py:160-
    166). A stable descending sort ranks equal priorities by index, as
    jax.lax.top_k does."""
    flat = mask2d.reshape(-1)
    pri = torch.where(flat, priorities, torch.full_like(priorities, -1.0))
    idx = torch.sort(pri, descending=True, stable=True).indices[:budget]
    count = torch.clamp(torch.minimum(n_take, torch.sum(flat)), max=budget)
    valid = torch.arange(budget, device=flat.device) < count
    return idx.to(torch.int32), valid


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the mean of the two middle values of an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def frame_to_gaussians(
    rgb: torch.Tensor,          # [H,W,3] in [0,1]
    depth: torch.Tensor,        # [H,W] metric
    score: torch.Tensor,        # [H,W] SuperPoint saliency
    camera: Camera,
    generator: torch.Generator | None = None,
    exposure_a=0.0,
    exposure_b=0.0,
    kp_budget: int = 16384,
    nonkp_budget: int = 8192,
    downsample: int = 64,
    point_size: float = 0.05,
    adaptive_pointsize: bool = True,
    score_thresh: float = 0.005,
    priorities: torch.Tensor | None = None,
):
    """Returns (values dict for GaussianScene.insert, valid [B])."""
    H, W = depth.shape
    dev = depth.device
    kp_budget = min(kp_budget, H * W)
    nonkp_budget = min(nonkp_budget, H * W)
    image_ab = torch.clamp(
        torch.exp(torch.as_tensor(exposure_a, dtype=torch.float32)) * rgb
        + exposure_b, 0.0, 1.0)

    kp_mask = (depth > 0.0) & (score > score_thresh)
    nonkp_mask = (depth > 0.0) & (score <= score_thresh)
    kp_idx, kp_valid = _select_first(kp_mask, kp_budget)
    n_take = torch.div(torch.sum(nonkp_mask), downsample,
                       rounding_mode="floor")
    if priorities is None:
        priorities = torch.rand((H * W,), generator=generator, device=dev)
    nk_idx, nk_valid = _select_random(nonkp_mask, nonkp_budget, n_take,
                                      priorities)

    idx = torch.cat([kp_idx, nk_idx]).long()
    valid = torch.cat([kp_valid, nk_valid])
    rows = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    cols = (idx % W).to(torch.float32)
    d = depth.reshape(-1)[idx]
    uv = torch.stack([cols, rows], dim=-1)
    xyz = camera.backproject(uv, d)
    col = image_ab.reshape(-1, 3)[idx]
    sc = score.reshape(-1)[idx]

    if adaptive_pointsize:
        psize = torch.clamp(point_size * _median(depth), max=0.05)
    else:
        psize = point_size
    dist2 = torch.clamp(mean_dist2_3nn(xyz, valid), min=1e-7) * psize
    log_scale = 0.5 * torch.log(dist2)                   # log(sqrt(dist2))

    B = idx.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    values = {
        "xyz": xyz,
        "f_dc": sh_mod.rgb_to_sh(col)[:, None, :],
        "f_rest": torch.zeros((B, 0, 3), **f32),
        "scaling": log_scale[:, None].repeat(1, 3),
        "rotation": torch.tensor([[1.0, 0, 0, 0]], **f32).repeat(B, 1),
        "opacity": torch.zeros((B, 1), **f32),           # sigmoid^-1(0.5)
        "marker": sc[:, None],
        "kp_score": torch.full((B, 1), 0.5, **f32),
    }
    return values, valid


def add_frame(scene: GaussianScene, opt_state: optim.AdamState,
              rgb, depth, score, camera: Camera, generator=None,
              exposure_a=0.0, exposure_b=0.0, **kw):
    """Insert a new RGB-D keyframe into the scene (reference
    extend_from_pcd_seq). Returns (scene, opt_state, n_added)."""
    values, valid = frame_to_gaussians(rgb, depth, score, camera, generator,
                                       exposure_a, exposure_b, **kw)
    if scene.f_rest.shape[1] != values["f_rest"].shape[1]:
        values["f_rest"] = torch.zeros(
            (valid.shape[0], scene.f_rest.shape[1], 3), dtype=torch.float32,
            device=valid.device)
    dst, ok = scene.slots_for(valid)
    new = {k: set_rows(getattr(scene, k), dst, values[k])
           for k in scene.PARAM_FIELDS}
    scene = scene.replace(alive=set_rows(scene.alive, dst, True), **new)
    return scene, optim.zero_slots(opt_state, dst), torch.sum(ok)
