"""Mid-training checkpoint / resume for the mapping trainer.

Port of ``splatloc_tpu.train.checkpoint``, with the same npz keys, so a
checkpoint the JAX package wrote loads into a port trainer and the other
way round. The full training state (scene, Adam moments, densification
stats, frame store, iteration counter) round-trips through one npz; the
numpy host RNG (window sampling) is pickled beside it in ``.hostrng``, as
the JAX package does.

The ``rng`` key holds a JAX PRNG key, which torch cannot continue: the port
ignores it on load and writes the key ``jax.random.PRNGKey(seed)`` would
make (uint32 [0, seed]). The port's own torch.Generator state goes to a
second side file, ``.torchrng``.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from splatloc_tpu_torch import convert
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train.mapping import MappingTrainer


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save(trainer: MappingTrainer, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {}
    for k in GaussianScene.PARAM_FIELDS:
        flat[f"scene_{k}"] = _np(getattr(trainer.scene, k))
    flat["scene_alive"] = _np(trainer.scene.alive)
    flat["opt_step"] = _np(trainer.opt_state.step)
    for k, v in trainer.opt_state.m.items():
        flat[f"m_{k}"] = _np(v)
    for k, v in trainer.opt_state.v.items():
        flat[f"v_{k}"] = _np(v)
    flat["stats_accum"] = _np(trainer.stats.xyz_gradient_accum)
    flat["stats_denom"] = _np(trainer.stats.denom)
    flat["stats_radii"] = _np(trainer.stats.max_radii2d)
    fs = trainer.frames
    flat["frames_n"] = np.asarray(fs.n)
    flat["frames_rgb"] = _np(fs.rgb[:fs.n])
    flat["frames_depth_mm"] = _np(fs.depth_mm[:fs.n]).astype(np.uint16)
    flat["frames_score"] = _np(fs.score[:fs.n])
    flat["frames_w2c"] = _np(fs.w2c[:fs.n])
    flat["frames_exposure"] = _np(fs.exposure[:fs.n])
    flat["iteration"] = np.asarray(trainer.iteration)
    flat["rng"] = np.asarray([0, trainer.seed & 0xFFFFFFFF], np.uint32)
    np.savez_compressed(path, **flat)
    with open(path + ".hostrng", "wb") as f:
        pickle.dump(trainer.host_rng.bit_generator.state, f)
    torch.save(trainer.generator.get_state(), path + ".torchrng")


def load(trainer: MappingTrainer, path: str) -> MappingTrainer:
    """Restore into an already-constructed trainer (same config and
    capacity), from a checkpoint of either package."""
    z = np.load(path, allow_pickle=False)
    names = GaussianScene.PARAM_FIELDS
    scene = {k: z[f"scene_{k}"] for k in names}
    scene["alive"] = z["scene_alive"]
    convert.trainer_state_from_numpy(
        trainer, scene=scene,
        adam={"step": z["opt_step"],
              "m": {k: z[f"m_{k}"] for k in names},
              "v": {k: z[f"v_{k}"] for k in names}},
        stats={"xyz_gradient_accum": z["stats_accum"],
               "denom": z["stats_denom"], "max_radii2d": z["stats_radii"]},
        frames={k: z[f"frames_{k}"] for k in (
            "n", "rgb", "depth_mm", "score", "w2c", "exposure")},
        iteration=int(z["iteration"]))
    if os.path.exists(path + ".hostrng"):
        with open(path + ".hostrng", "rb") as f:
            trainer.host_rng.bit_generator.state = pickle.load(f)
    if os.path.exists(path + ".torchrng"):
        trainer.generator.set_state(torch.load(path + ".torchrng"))
    return trainer
