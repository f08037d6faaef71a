"""Descriptor-field checkpoints (reference train_decoder.py:27-82).

Port of ``splatloc_tpu.train.decoder_train``'s ``save_params`` and
``load_params`` with the same npz layout (``table``, ``layer_0``, ...), so
a decoder the JAX package saved loads into the port and the other way
round. Training the decoder (the optimizer and epoch loop) is not ported
yet (ROADMAP queue A).
"""
from __future__ import annotations

import os

import numpy as np
import torch


def save_params(params: dict, path: str):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {"table": params["table"].detach().cpu().numpy()}
    for i, w in enumerate(params["layers"]):
        flat[f"layer_{i}"] = w.detach().cpu().numpy()
    np.savez(path, **flat)


def load_params(path: str, device="cuda") -> dict:
    """The decoder params saved at ``path``, as float32 tensors on
    ``device``."""
    with np.load(path) as z:
        n = 0
        while f"layer_{n}" in z:
            n += 1

        def t(k):
            return torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
        return {"table": t("table"), "layers": [t(f"layer_{i}")
                                                for i in range(n)]}
