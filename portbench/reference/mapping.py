"""Plain mapping step: the reference's loss over a window of keyframes,
gradients by autograd through ``render``, the key-primitive freeze and
per-group Adam with the xyz schedule (train_gaussians.py map() body,
gaussian_model.py's param groups).

Also the plain keyframe quantisation (what storing a frame does to it) and
the check of keyframe insertion: each inserted Gaussian against the pixel
it was lifted from.

``dtype`` runs every tensor of a step in that precision: float32 is the
reference, bfloat16 the control.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.render import SH_C0, Intrinsics, render

FIELDS = ("xyz", "f_dc", "opacity", "marker", "kp_score", "scaling",
          "rotation")
MARKER_THRESH = 0.005
ISO_WEIGHT = 0.01
SPATIAL_LR_SCALE = 6.0
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-15


def quantise_frame(rgb: np.ndarray, depth: np.ndarray, score: np.ndarray,
                   thresh: float):
    """A keyframe as the trainer stores it: uint8 colour, depth zeroed
    where the colour is dark and kept in whole millimetres, float16
    score. Returns float32 (rgb [H,W,3], depth m [H,W], score [H,W])."""
    valid = rgb.astype(np.float32).sum(-1) > thresh
    depth = np.where(valid, depth, 0.0).astype(np.float32)
    rgb8 = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
    mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
    return (rgb8.astype(np.float32) / 255.0,
            mm.astype(np.int32).astype(np.float32) / 1000.0,
            score.astype(np.float16).astype(np.float32))


def xyz_lr(step: int, cfg: dict) -> float:
    t = min(max(step / cfg["position_lr_max_steps"], 0.0), 1.0)
    lr_i = cfg["position_lr_init"] * SPATIAL_LR_SCALE
    lr_f = cfg["position_lr_final"] * SPATIAL_LR_SCALE
    return math.exp(math.log(lr_i) * (1 - t) + math.log(lr_f) * t)


def learning_rates(step: int, opt: dict) -> dict:
    return {"xyz": xyz_lr(step, opt), "f_dc": opt["feature_lr"],
            "opacity": opt["opacity_lr"], "marker": opt["marker_lr"],
            "kp_score": opt["kp_score_lr"],
            "scaling": opt["scaling_lr"] * SPATIAL_LR_SCALE,
            "rotation": opt["rotation_lr"]}


def step_loss(p: dict, alive, frames: list, K: Intrinsics, thresh: float,
              view_scale: float = 1.0):
    """The summed loss of a window: per view masked L1 colour + L1 depth
    (means over all pixels) + BCE of the composited kp channel, and the
    isotropic regulariser of the key primitives. ``view_scale`` weighs the
    views' sum (a fault planted in the reference: a window cut short)."""
    total = 0.0
    for rgb_gt, depth_gt, score_gt, w2c in frames:
        img, dep, _ = render(p["xyz"], p["scaling"], p["rotation"],
                             p["opacity"], p["f_dc"], p["kp_score"], alive,
                             w2c, K)
        rgb_mask = (rgb_gt.sum(-1) > thresh)[..., None]
        d_mask = depth_gt > 0.01
        l1 = (img[..., :3] * rgb_mask - rgb_gt * rgb_mask).abs().mean()
        ld = (dep * d_mask - depth_gt * d_mask).abs().mean()
        prob = torch.sigmoid(img[..., 3].reshape(-1)).clamp(1e-7, 1 - 1e-7)
        t = score_gt.reshape(-1)
        bce = -(t * torch.log(prob) + (1 - t) * torch.log(1 - prob)).mean()
        total = total + l1 + ld + bce
    marker = p["marker"][:, 0].detach()
    key = (marker > MARKER_THRESH) & alive
    iso = ((torch.exp(p["scaling"]).mean(-1) / (0.02 * (1 - marker)) - 1
            ).abs())
    iso = torch.where(key, iso, torch.zeros_like(iso)).sum() / key.sum(
    ).clamp_min(1)
    return view_scale * total + ISO_WEIGHT * iso


def run_steps(state: dict, alive, frames: list, windows: list,
              K: Intrinsics, opt: dict, thresh: float,
              dtype=torch.float32, view_scale: float = 1.0) -> dict:
    """Steps 1..len(windows) from ``state`` (raw parameters by field).
    ``frames`` holds every keyframe as (rgb, depth, score, w2c) tensors,
    ``windows`` the keyframe indices of each step. Returns the loss of each
    step, the first step's gradients as Adam gets them, and each field's
    change over all the steps."""
    p = {k: state[k].to(dtype) for k in FIELDS}
    start = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    cast = [tuple(x.to(dtype) for x in f) for f in frames]
    key = (state["marker"][:, 0] > MARKER_THRESH)[:, None]
    losses, grad1 = [], None
    for s, win in enumerate(windows, start=1):
        leaves = {k: v.detach().requires_grad_(k != "marker")
                  for k, v in p.items()}
        loss = step_loss(leaves, alive, [cast[i] for i in win], K, thresh,
                         view_scale)
        names = [k for k in FIELDS if k != "marker"]
        gs = torch.autograd.grad(loss, [leaves[k] for k in names],
                                 allow_unused=True)
        g = {k: (torch.zeros_like(p[k]) if x is None else x)
             for k, x in zip(names, gs)}
        g["xyz"] = torch.where(key, torch.zeros_like(g["xyz"]), g["xyz"])
        g["marker"] = torch.zeros_like(p["marker"])
        if grad1 is None:
            grad1 = {k: x.detach().float() for k, x in g.items()}
        losses.append(float(loss.detach()))
        lrs = learning_rates(s, opt)
        c1, c2 = 1 - B1 ** s, 1 - B2 ** s
        for k in FIELDS:
            m[k] = B1 * m[k] + (1 - B1) * g[k]
            v2[k] = B2 * v2[k] + (1 - B2) * g[k] * g[k]
            p[k] = (p[k] - lrs[k] * (m[k] / c1)
                    / (torch.sqrt(v2[k] / c2) + ADAM_EPS)).detach()
    return {"loss": losses, "grad1": grad1,
            "change": {k: (p[k] - start[k]).float() for k in FIELDS}}


def insertion_gaps(added: dict, frame, w2c: torch.Tensor, K: Intrinsics,
                   point_size: float, downsample: int, thresh: float,
                   dtype=torch.float32) -> dict:
    """How far the Gaussians one keyframe added lie from what lifting its
    pixels gives, each in its own unit: ``insert_count``, the count of
    lifted pixels against the count of key pixels plus a 1/``downsample``
    share of the rest (the others are inf where it differs); each centre
    reprojected to the integer pixel grid, ``insert_px`` from the nearest
    pixel centre and ``insert_depth_m`` against the stored depth there;
    ``insert_color``, its colour against the pixel's (SH DC);
    ``insert_scale``, its log-scale against the 3-NN rule."""
    rgb, depth, score = (x.to(dtype) for x in frame)
    H, W = depth.shape
    valid = depth > 0
    kp = valid & (score > MARKER_THRESH)
    n_kp = min(int(kp.sum()), 16384)
    n_rest = min(int((valid & ~kp).sum()) // downsample, 8192)
    xyz = added["xyz"].to(dtype)
    if xyz.shape[0] != n_kp + n_rest:
        inf = float("inf")
        return {"insert_count": float(abs(xyz.shape[0] - n_kp - n_rest)),
                "insert_px": inf, "insert_depth_m": inf,
                "insert_color": inf, "insert_scale": inf}
    R, t = w2c[:3, :3].to(dtype), w2c[:3, 3].to(dtype)
    pc = xyz @ R.T + t
    u = K.fx * pc[:, 0] / pc[:, 2] + (K.cx - 0.5)
    v = K.fy * pc[:, 1] / pc[:, 2] + (K.cy - 0.5)
    ui = torch.round(u).long().clamp(0, W - 1)
    vi = torch.round(v).long().clamp(0, H - 1)
    dc = (rgb[vi, ui] - 0.5) / SH_C0
    med = torch.sort(depth.reshape(-1)).values
    n = med.shape[0]
    med = med[n // 2] if n % 2 else 0.5 * (med[n // 2 - 1] + med[n // 2])
    psize = min(point_size * float(med), 0.05)
    nn3 = []
    for r0 in range(0, xyz.shape[0], 2048):
        d2 = torch.cdist(xyz[r0:r0 + 2048].float(), xyz.float(),
                         compute_mode="donot_use_mm_for_euclid_dist").pow(2)
        d2[torch.arange(d2.shape[0]), r0 + torch.arange(d2.shape[0])] = \
            float("inf")
        nn3.append(torch.topk(d2, 3, largest=False).values.mean(-1))
    nn3 = torch.cat(nn3).to(dtype)
    log_s = 0.5 * torch.log(nn3.clamp_min(1e-7) * psize)
    return {"insert_count": 0.0,
            "insert_px": float(torch.maximum((u - ui).abs().max(),
                                             (v - vi).abs().max())),
            "insert_depth_m": float((pc[:, 2] - depth[vi, ui]).abs().max()),
            "insert_color": float((added["f_dc"][:, 0, :].to(dtype)
                                   - dc).abs().max() * SH_C0),
            "insert_scale": float((added["scaling"].to(dtype)
                                   - log_s[:, None]).abs().max())}
