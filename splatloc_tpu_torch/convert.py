"""Port objects from numpy fields.

A JAX-side ``GaussianScene`` or ``Camera`` crosses into the port as a dict
of numpy arrays (``{name: np.asarray(getattr(obj, name))}``), so neither
package imports the other.
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
