"""Port objects from numpy fields.

A JAX-side ``GaussianScene``, ``Camera``, Adam state, densification stats or
whole trainer state crosses into the port as numpy arrays
(``{name: np.asarray(getattr(obj, name))}``), so neither package imports
the other.
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.scene.gaussians import GaussianScene

_SCENE_FIELDS = ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
                 "marker", "kp_score")
_CAMERA_FIELDS = ("w2c", "fx", "fy", "cx", "cy", "width", "height")


def scene_from_numpy(fields: dict[str, np.ndarray], sh_degree: int,
                     device="cuda") -> GaussianScene:
    """GaussianScene on ``device`` from the fields of a JAX GaussianScene
    (float32 parameters and a bool ``alive``)."""
    missing = [k for k in _SCENE_FIELDS + ("alive",) if k not in fields]
    if missing:
        raise KeyError(f"scene fields missing: {missing}")
    tensors = {k: torch.as_tensor(np.asarray(fields[k], np.float32),
                                  device=device) for k in _SCENE_FIELDS}
    alive = torch.as_tensor(np.asarray(fields["alive"], bool), device=device)
    expected = (sh_degree + 1) ** 2 - 1
    if tensors["f_rest"].shape[1] != expected:
        raise ValueError(f"f_rest has {tensors['f_rest'].shape[1]} "
                         f"coefficients; SH degree {sh_degree} needs "
                         f"{expected}")
    return GaussianScene(alive=alive, sh_degree=sh_degree, **tensors)


def camera_from_numpy(fields: dict, device="cuda") -> Camera:
    """Camera on ``device`` from the fields of a JAX Camera (w2c, fx, fy,
    cx, cy, width, height; znear and zfar optional)."""
    missing = [k for k in _CAMERA_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"camera fields missing: {missing}")
    return Camera.create(np.asarray(fields["w2c"], np.float32),
                         np.float32(fields["fx"]), np.float32(fields["fy"]),
                         np.float32(fields["cx"]), np.float32(fields["cy"]),
                         int(fields["width"]), int(fields["height"]),
                         znear=float(fields.get("znear", 0.01)),
                         zfar=float(fields.get("zfar", 100.0)),
                         device=device)


def adam_from_numpy(step, m: dict, v: dict, device="cuda"):
    """optim.AdamState on ``device`` from a JAX AdamState's step and
    moment dicts."""
    from splatloc_tpu_torch.scene import optim

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)
    return optim.AdamState(
        step=torch.as_tensor(np.asarray(step, np.int32), device=device),
        m={k: t(x) for k, x in m.items()}, v={k: t(x) for k, x in v.items()})


def stats_from_numpy(fields: dict, device="cuda"):
    """densify.DensifyStats on ``device`` from a JAX DensifyStats' fields
    (xyz_gradient_accum, denom, max_radii2d)."""
    from splatloc_tpu_torch.scene import densify
    return densify.DensifyStats(**{
        k: torch.as_tensor(np.asarray(fields[k], np.float32), device=device)
        for k in ("xyz_gradient_accum", "denom", "max_radii2d")})


def trainer_state_from_numpy(trainer, scene: dict, adam: dict, stats: dict,
                             frames: dict, iteration: int):
    """Load a JAX trainer's state into the port's ``trainer`` (same config
    and capacity): ``scene`` the GaussianScene fields, ``adam`` {step, m,
    v}, ``stats`` the DensifyStats fields, ``frames`` the first n frames of
    its FrameStore {n, rgb, depth_mm, score, w2c, exposure}, and the
    iteration counter. The JAX PRNG key has no torch counterpart and is not
    taken. Returns the trainer."""
    dev = trainer.device
    cap = trainer.scene.capacity
    if np.asarray(scene["xyz"]).shape[0] != cap:
        raise ValueError(f"scene has {np.asarray(scene['xyz']).shape[0]} "
                         f"slots, the trainer {cap}")
    trainer.scene = scene_from_numpy(scene, trainer.scene.sh_degree, dev)
    trainer.opt_state = adam_from_numpy(adam["step"], adam["m"], adam["v"],
                                        dev)
    trainer.stats = stats_from_numpy(stats, dev)
    fs = trainer.frames
    n = int(frames["n"])
    fs.n = n
    for k, dtype in (("rgb", np.uint8), ("depth_mm", np.int32),
                     ("score", np.float16), ("w2c", np.float32),
                     ("exposure", np.float32)):
        getattr(fs, k)[:n] = torch.from_numpy(
            np.asarray(frames[k]).astype(dtype)).to(dev)
    trainer.iteration = int(iteration)
    return trainer
