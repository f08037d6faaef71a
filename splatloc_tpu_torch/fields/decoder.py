"""Unbiased 3D descriptor field: hash-grid encoding + bias-free MLP.

Port of ``splatloc_tpu.fields.decoder`` (the reference FeatureDecoder,
models/decoders.py:7-67): position normalized into the scene bound box,
hash-encoded, passed through a ``num_layers`` bias-free ReLU MLP to
``final_dim`` (256) and L2-normalized.

The JAX package multiplies bfloat16 operands with float32 accumulation
(``preferred_element_type=f32``). A bf16 ``torch.matmul`` would round its
result to bf16 once more, so here the operands are rounded to bf16, cast
back to float32 and multiplied in float32 with TF32 off: products of bf16
values are exact in float32, and the sums accumulate in float32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.fields import hashgrid


@dataclass(frozen=True)
class FeatureFieldConfig:
    bound: tuple = (((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)))
    voxel_sdf: float = 0.06
    num_layers: int = 4
    hidden_dim: int = 128
    final_dim: int = 256
    grid: hashgrid.HashGridConfig | None = None   # derived from the bound

    @property
    def grid_config(self) -> hashgrid.HashGridConfig:
        if self.grid is not None:
            return self.grid
        lo = np.array([b[0] for b in self.bound])
        hi = np.array([b[1] for b in self.bound])
        desired = int((hi - lo).max() / self.voxel_sdf)
        return hashgrid.HashGridConfig(desired_resolution=max(desired, 16))

    @classmethod
    def from_config(cls, config: dict) -> "FeatureFieldConfig":
        dec = config["decoder"]
        return cls(bound=tuple(tuple(b) for b in config["scene"]["bound"]),
                   voxel_sdf=config["scene"]["voxel_sdf"],
                   num_layers=dec["num_layers"],
                   hidden_dim=dec["hidden_dim"],
                   final_dim=dec["final_dim"])


def init_decoder(cfg: FeatureFieldConfig,
                 generator: torch.Generator | None = None,
                 device="cuda") -> dict:
    """{"table": [L, T, F], "layers": [[in, out], ...]}: the table uniform
    in +-1e-4, each layer Kaiming-uniform like torch Linear's default."""
    gcfg = cfg.grid_config
    table = hashgrid.init_hashgrid(gcfg, generator, device=device)
    layers = []
    in_dim = gcfg.out_dim
    for l in range(cfg.num_layers):
        out_dim = cfg.final_dim if l == cfg.num_layers - 1 else cfg.hidden_dim
        bound = 1.0 / np.sqrt(in_dim)
        u = torch.rand((in_dim, out_dim), generator=generator, device=device)
        layers.append((2.0 * u - 1.0) * bound)
        in_dim = out_dim
    return {"table": table, "layers": layers}


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@full_float32()
def decode(params: dict, pos: torch.Tensor,
           cfg: FeatureFieldConfig) -> torch.Tensor:
    """pos [B,3] world -> [B, final_dim] L2-normalized descriptors."""
    gcfg = cfg.grid_config
    lo = hashgrid._device_const([b[0] for b in cfg.bound], torch.float32,
                                pos.device)
    hi = hashgrid._device_const([b[1] for b in cfg.bound], torch.float32,
                                pos.device)
    pos01 = (pos - lo) / (hi - lo)
    x = hashgrid.encode(params["table"], pos01, gcfg)
    for l, w in enumerate(params["layers"]):
        x = _bf16(x) @ _bf16(w)
        if l != len(params["layers"]) - 1:
            x = torch.relu(x)
    norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=1e-12)


def cosine_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """1 - mean cosine similarity (train_decoder.py:23-25)."""
    pn = pred / torch.clamp(torch.linalg.norm(pred, dim=-1, keepdim=True),
                            min=1e-12)
    gn = gt / torch.clamp(torch.linalg.norm(gt, dim=-1, keepdim=True),
                          min=1e-12)
    return 1.0 - torch.mean(torch.sum(pn * gn, dim=-1))
