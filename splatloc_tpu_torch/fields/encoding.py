"""Input encodings: the full tiny-cuda-nn ``get_encoder`` surface.

Port of ``splatloc_tpu.fields.encoding`` (the reference
models/encoding.py:5-97, tcnn Encoding): Dense grid, Hash/Tiled grid,
SphericalHarmonics, OneBlob, Frequency, Identity. The grid paths wrap
``fields/hashgrid.py``; the rest are closed-form elementwise features.
Every encoder is (init, apply, out_dim): ``init(generator, device)``
makes its params (a dict of tensors), ``apply(params, x)`` encodes;
``convert.encoder_from_numpy`` carries the JAX package's params across.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from splatloc_tpu_torch.fields import hashgrid


@dataclass(frozen=True)
class Encoder:
    name: str
    out_dim: int
    init: Callable[..., Any] = field(compare=False)
    apply: Callable[[Any, torch.Tensor], torch.Tensor] = field(compare=False)


def _no_params(generator=None, device="cuda"):
    return {}


# -- spherical harmonics ---------------------------------------------------

def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis values for unit directions d [B,3], bands 0..degree-1
    -> [B, degree^2] (tcnn SphericalHarmonics layout, degree <= 4)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"SH degree {degree} not in 1..4")
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    out = [torch.full(x.shape, 0.28209479177387814, dtype=d.dtype,
                      device=d.device)]
    if degree > 1:
        out += [-0.48860251190291987 * y,
                0.48860251190291987 * z,
                -0.48860251190291987 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [1.0925484305920792 * xy,
                -1.0925484305920792 * yz,
                0.94617469575755997 * zz - 0.31539156525251999,
                -1.0925484305920792 * xz,
                0.54627421529603959 * (xx - yy)]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * xx + yy),
                2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * zz),
                0.3731763325901154 * z * (5.0 * zz - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * zz),
                1.4453057213202769 * z * (xx - yy),
                0.59004358992664352 * x * (-xx + 3.0 * yy)]
    return torch.stack(out, dim=-1)


def _sh_encoder(input_dim: int, degree: int) -> Encoder:
    if input_dim != 3:
        raise ValueError("SH encoding takes 3-D directions")

    def apply(_params, x):
        # tcnn convention: inputs in [0,1]^3 are mapped to [-1,1]^3
        d = x * 2.0 - 1.0
        n = torch.linalg.norm(d, dim=-1, keepdim=True)
        return sh_basis(d / torch.clamp(n, min=1e-12), degree)

    return Encoder("spherical", degree * degree, _no_params, apply)


# -- one-blob --------------------------------------------------------------

def _oneblob_encoder(input_dim: int, n_bins: int) -> Encoder:
    """Gaussian one-blob (NRC sec. 4.1, tcnn OneBlob): each input coordinate
    activates a Gaussian of sigma = 1/n_bins evaluated at the bin centers."""
    centers = (np.arange(n_bins, dtype=np.float32) + 0.5) / n_bins
    sigma = 1.0 / n_bins
    norm = 1.0 / (sigma * math.sqrt(2.0 * math.pi))

    def apply(_params, x):
        c = torch.from_numpy(centers).to(x.device)
        d = x[..., None] - c                               # [B, D, bins]
        blobs = norm * torch.exp(-0.5 * (d / sigma) ** 2) / n_bins
        return blobs.reshape(*x.shape[:-1], input_dim * n_bins)

    return Encoder("blob", input_dim * n_bins, _no_params, apply)


# -- frequency -------------------------------------------------------------

def _frequency_encoder(input_dim: int, n_frequencies: int) -> Encoder:
    """NeRF-style sin/cos at octave frequencies (tcnn Frequency):
    per input dim, (sin, cos)(2^l * pi * x) for l in 0..n-1."""
    freqs = (2.0 ** np.arange(n_frequencies, dtype=np.float32)) * np.pi

    def apply(_params, x):
        a = x[..., None] * torch.from_numpy(freqs.astype(np.float32)).to(
            x.device)                                      # [B, D, F]
        enc = torch.stack([torch.sin(a), torch.cos(a)], -1)  # [B, D, F, 2]
        return enc.reshape(*x.shape[:-1], input_dim * n_frequencies * 2)

    return Encoder("freq", input_dim * n_frequencies * 2, _no_params, apply)


# -- grids -----------------------------------------------------------------

def _grid_encoder(name, input_dim, n_levels, level_dim, base_resolution,
                  log2_hashmap_size, desired_resolution) -> Encoder:
    if input_dim != 3:
        raise ValueError("grid encodings are 3-D")
    cfg = hashgrid.HashGridConfig(
        n_levels=n_levels, n_features=level_dim,
        base_resolution=base_resolution,
        log2_hashmap_size=log2_hashmap_size,
        desired_resolution=desired_resolution)

    def init(generator=None, device="cuda"):
        return {"table": hashgrid.init_hashgrid(cfg, generator,
                                                device=device)}

    def apply(params, x):
        return hashgrid.encode(params["table"], x, cfg)

    return Encoder(name, cfg.out_dim, init, apply)


def _dense_encoder(input_dim, n_levels, level_dim, base_resolution,
                   desired_resolution) -> Encoder:
    """Multi-level dense grid (tcnn Grid type=Dense): exact (res+1)^3 table
    per level, trilinear interpolation."""
    if input_dim != 3:
        raise ValueError("grid encodings are 3-D")
    scale = (1.0 if n_levels == 1 else
             math.exp(math.log(desired_resolution / base_resolution)
                      / (n_levels - 1)))
    resolutions = [int(math.floor(base_resolution * scale ** l))
                   for l in range(n_levels)]

    def init(generator=None, device="cuda"):
        return {"tables": [
            (2.0 * torch.rand(((r + 1) ** 3, level_dim), generator=generator,
                              device=device) - 1.0) * 1e-4
            for r in resolutions]}

    def apply(params, x):
        x = torch.clamp(x, 0.0, 1.0)
        outs = []
        for table, res in zip(params["tables"], resolutions):
            p = x * res
            p0 = torch.clamp(torch.floor(p).to(torch.int64), 0, res - 1)
            w = p - p0.to(p.dtype)
            feats = 0.0
            for corner in range(8):
                dx, dy, dz = (corner >> 2) & 1, (corner >> 1) & 1, corner & 1
                idx = ((p0[..., 0] + dx) * (res + 1)
                       + p0[..., 1] + dy) * (res + 1) + p0[..., 2] + dz
                weight = ((w[..., 0] if dx else 1 - w[..., 0])
                          * (w[..., 1] if dy else 1 - w[..., 1])
                          * (w[..., 2] if dz else 1 - w[..., 2]))
                feats = feats + weight[..., None] * table[idx]
            outs.append(feats)
        return torch.cat(outs, dim=-1)

    return Encoder("dense", n_levels * level_dim, init, apply)


def get_encoder(encoding: str, input_dim: int = 3, degree: int = 4,
                n_bins: int = 16, n_frequencies: int = 12,
                n_levels: int = 16, level_dim: int = 2,
                base_resolution: int = 16, log2_hashmap_size: int = 19,
                desired_resolution: int = 512) -> Encoder:
    """Name-dispatched encoder factory; same selection rules and defaults as
    the reference get_encoder (models/encoding.py:5-97)."""
    e = encoding.lower()
    if "dense" in e:
        # reference pins dense grids to 4 levels (models/encoding.py:13)
        return _dense_encoder(input_dim, 4, level_dim, base_resolution,
                              desired_resolution)
    if "hash" in e or "tiled" in e:
        return _grid_encoder("hash", input_dim, n_levels, level_dim,
                             base_resolution, log2_hashmap_size,
                             desired_resolution)
    if "spherical" in e:
        return _sh_encoder(input_dim, degree)
    if "blob" in e:
        return _oneblob_encoder(input_dim, n_bins)
    if "freq" in e:
        return _frequency_encoder(input_dim, n_frequencies)
    if "identity" in e:
        return Encoder("identity", input_dim, _no_params,
                       lambda _p, x: x)
    raise ValueError(f"unknown encoding '{encoding}'")
