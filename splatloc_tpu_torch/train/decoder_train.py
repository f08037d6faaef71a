"""Descriptor-field training (reference train_decoder.py:27-82).

Port of ``splatloc_tpu.train.decoder_train``: Adam betas (0.9, 0.99); the
MLP group carries weight decay 1e-6 (torch's coupled L2 is optax's
``add_decayed_weights`` before ``scale_by_adam``), the hash table group
eps 1e-15; lr 1e-3; batch 256; cosine loss. Batches are drawn from the
same ``np.random.default_rng(seed).permutation`` per epoch as the JAX
package draws them, so both see identical batches.

A step (forward, backward and Adam) runs in full float32: the caller's
TF32 switches touch neither the MLP's products nor their gradients. The
epoch's loss stays on the device: one host read per logged epoch, none
per step. Checkpoints use the JAX package's npz layout (``table``,
``layer_0``, ...), so a decoder either package saved loads into the other.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.fields import (FeatureFieldConfig, cosine_loss, decode,
                                       init_decoder)


def make_optimizer(params: dict, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam over the reference's two param groups."""
    return torch.optim.Adam(
        [{"params": params["layers"], "weight_decay": 1e-6, "eps": 1e-8},
         {"params": [params["table"]], "weight_decay": 0.0, "eps": 1e-15}],
        lr=lr, betas=(0.9, 0.99))


def train_step(params: dict, optimizer: torch.optim.Adam, x: torch.Tensor,
               f: torch.Tensor, cfg: FeatureFieldConfig) -> torch.Tensor:
    """One Adam step on the batch (x [B,3], f [B,D]); returns its loss,
    detached, on the device."""
    with full_float32():
        loss = cosine_loss(decode(params, x, cfg), f)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
    return loss.detach()


def make_train_epoch(cfg: FeatureFieldConfig, optimizer: torch.optim.Adam,
                     params: dict):
    def epoch_fn(xyz: torch.Tensor, feats: torch.Tensor,
                 perm: torch.Tensor) -> torch.Tensor:
        """One epoch over shuffled batches. xyz [N,3], feats [N,D], perm
        [n_batches, batch] batch indices on the device; returns the mean
        loss, on the device."""
        total = torch.zeros((), device=xyz.device)
        for idx in perm:
            total = total + train_step(params, optimizer, xyz[idx],
                                       feats[idx], cfg)
        return total / perm.shape[0]

    return epoch_fn


def train_decoder(cfg: FeatureFieldConfig, xyz: np.ndarray, feats: np.ndarray,
                  num_epochs: int = 41, lr: float = 1e-3, batch: int = 256,
                  seed: int = 0, log_every: int = 10,
                  params: dict | None = None, device="cuda"):
    """Train the field on a fused cloud; returns (params, final_loss).
    ``params`` are trained in place when given; otherwise they start from
    ``init_decoder`` with a generator seeded by ``seed`` (JAX's PRNG
    stream has no torch counterpart)."""
    if params is None:
        params = init_decoder(cfg, torch.Generator(device).manual_seed(seed),
                              device=device)
    for p in [params["table"], *params["layers"]]:
        p.requires_grad_(True)
    optimizer = make_optimizer(params, lr)
    epoch_fn = make_train_epoch(cfg, optimizer, params)

    n = xyz.shape[0]
    batch = min(batch, n)
    n_batches = max(n // batch, 1)
    xyz_d = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    feats_d = torch.as_tensor(np.asarray(feats, np.float32), device=device)
    rng = np.random.default_rng(seed)
    loss = None
    for ep in range(num_epochs):
        perm = rng.permutation(n)[: n_batches * batch].reshape(n_batches,
                                                               batch)
        loss = epoch_fn(xyz_d, feats_d, torch.from_numpy(perm).to(device))
        if log_every and (ep % log_every == 0 or ep == num_epochs - 1):
            print(f"decoder epoch {ep}: cos loss {float(loss):.4f}")
    for p in [params["table"], *params["layers"]]:
        p.requires_grad_(False)
    return params, float(loss)


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
