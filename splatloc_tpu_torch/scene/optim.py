"""Per-group Adam for the Gaussian scene (functional, surgery-free).

Port of ``splatloc_tpu.scene.optim``. The reference uses torch.optim.Adam
with one param-group per field (gaussian_model.py:250-309, eps=1e-15) and
performs tensor surgery on the optimizer state at every densify/prune. With
padded-capacity buffers the state shapes never change; surgery reduces to
zeroing moment rows at (re)allocated slots, matching torch semantics where
new tensors start with zero state.

The xyz learning rate follows the reference's log-lerp schedule
(general_utils.py:79-94 ``helper``), computed in float32 on the device of
the step counter, as the JAX package computes it.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from splatloc_tpu_torch.scene.gaussians import set_rows


@dataclasses.dataclass(frozen=True)
class AdamState:
    step: torch.Tensor       # scalar int32 (shared across groups, like torch)
    m: dict                  # field -> tensor
    v: dict                  # field -> tensor

    def replace(self, **changes) -> "AdamState":
        return dataclasses.replace(self, **changes)


def init(params: dict) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def update(params: dict, grads: dict, state: AdamState, lrs: dict,
           b1: float = 0.9, b2: float = 0.999, eps: float = 1e-15):
    """One Adam step with per-group learning rates.

    lrs: field -> scalar lr (a float, or a 0-d float32 tensor for the
    scheduled xyz rate). Returns (new_params, new_state)."""
    t = state.step + 1
    tf = t.to(torch.float32)
    # constants made on the device by a fill: a tensor copied from a host
    # scalar would wait for the stream
    c1 = 1.0 - torch.pow(torch.full_like(tf, b1), tf)
    c2 = 1.0 - torch.pow(torch.full_like(tf, b2), tf)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        m = b1 * state.m[k] + (1 - b1) * g
        v = b2 * state.v[k] + (1 - b2) * (g * g)
        mhat = m / c1
        vhat = v / c2
        new_p[k] = p - lrs[k] * mhat / (torch.sqrt(vhat) + eps)
        new_m[k] = m
        new_v[k] = v
    return new_p, AdamState(step=t, m=new_m, v=new_v)


def zero_slots(state: AdamState, idx: torch.Tensor) -> AdamState:
    """Zero the moment rows at the given slot indices for every field
    (fresh Adam state for newly inserted Gaussians; OOB indices dropped)."""
    return state.replace(m={k: set_rows(a, idx, 0.0)
                            for k, a in state.m.items()},
                         v={k: set_rows(a, idx, 0.0)
                            for k, a in state.v.items()})


def zero_field(state: AdamState, field: str) -> AdamState:
    """Zero the full moment state of one field: the reference's
    replace_tensor_to_optimizer semantics used by opacity resets."""
    m = dict(state.m)
    v = dict(state.v)
    m[field] = torch.zeros_like(m[field])
    v[field] = torch.zeros_like(v[field])
    return state.replace(m=m, v=v)


def xyz_lr(step, lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
           max_steps=1000000):
    """Log-lerp LR schedule (reference general_utils.py ``helper``), in
    float32: ``step`` is an int (computed on the host) or a tensor (its
    device is kept)."""
    step = torch.as_tensor(step).to(torch.float32)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(torch.log(torch.full_like(step, lr_init)) * (1 - t)
                         + torch.log(torch.full_like(step, lr_final)) * t)
    return delay_rate * log_lerp


def make_lrs(opt_params: dict, spatial_lr_scale: float, step) -> dict:
    """Per-field LRs mirroring the reference param groups
    (gaussian_model.py:255-299)."""
    return {
        "xyz": xyz_lr(step,
                      opt_params["position_lr_init"] * spatial_lr_scale,
                      opt_params["position_lr_final"] * spatial_lr_scale,
                      lr_delay_mult=opt_params["position_lr_delay_mult"],
                      max_steps=opt_params["position_lr_max_steps"]),
        "f_dc": opt_params["feature_lr"],
        "f_rest": opt_params["feature_lr"] / 20.0,
        "opacity": opt_params["opacity_lr"],
        "marker": opt_params["marker_lr"],
        "kp_score": opt_params["kp_score_lr"],
        "scaling": opt_params["scaling_lr"] * spatial_lr_scale,
        "rotation": opt_params["rotation_lr"],
    }
