"""Descriptor autoencoder (reference autoencoder/model.py:5-46).

Port of ``splatloc_tpu.fields.autoencoder``: 256-d -> low-d bottleneck ->
256-d MLP with L2-normalized bottleneck and output, carried for
capability parity and optional descriptor compression. Params are
``{"enc": [{"w": [in, out], "b": [out]}, ...], "dec": [...]}``, the JAX
package's layout (``convert.autoencoder_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32


def init_autoencoder(generator: torch.Generator | None = None,
                     encoder_dims=(256, 128, 64, 32, 16),
                     decoder_dims=(32, 64, 128, 256, 256), in_dim: int = 256,
                     device="cuda") -> dict:
    def layers(dims):
        out = []
        for i in range(len(dims) - 1):
            bound = 1.0 / np.sqrt(dims[i])
            u = torch.rand((dims[i], dims[i + 1]), generator=generator,
                           device=device)
            out.append({"w": (2.0 * u - 1.0) * bound,
                        "b": torch.zeros((dims[i + 1],), device=device)})
        return out
    return {"enc": layers([in_dim] + list(encoder_dims)),
            "dec": layers([encoder_dims[-1]] + list(decoder_dims))}


def _mlp(layers, x):
    for i, lay in enumerate(layers):
        x = x @ lay["w"] + lay["b"]
        if i != len(layers) - 1:
            x = torch.relu(x)
    return x


def _l2(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-12)


@full_float32()
def encode(params, x):
    return _l2(_mlp(params["enc"], x))


@full_float32()
def decode(params, z):
    return _l2(_mlp(params["dec"], z))


def forward(params, x):
    return decode(params, encode(params, x))
