"""Descriptor-field training entry point (reference train_decoder.py).

Port of ``splatloc_tpu.cli.train_decoder``: the fused cloud
(``sp_inloc_pc.ply`` + ``sp_inloc_feat.npy``) trains the field, saved to
``<save_dir>/train_feat/ckpt.npz`` in the JAX package's layout. Runs on
``--device`` (CUDA unless the caller asks for the CPU).

Usage: python -m splatloc_tpu_torch.cli.train_decoder --config <yaml>
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from splatloc_tpu_torch.cli.config import load_config, save_dir_for
from splatloc_tpu_torch.fields import FeatureFieldConfig
from splatloc_tpu_torch.scene.ply import read_ply_vertices
from splatloc_tpu_torch.train.decoder_train import save_params, train_decoder


def run(config: dict, save_dir: str, num_epochs: int = 41, lr: float = 1e-3,
        device="cuda") -> str:
    from splatloc_tpu_torch.data import load_dataset
    dataset = load_dataset(config, train=True)

    v = read_ply_vertices(dataset.sparse_ply)
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    feats = np.load(dataset.sparse_feature).astype(np.float32)
    if feats.shape[0] != xyz.shape[0]:
        raise ValueError(f"{feats.shape[0]} features for {xyz.shape[0]} "
                         f"points")

    cfg = FeatureFieldConfig.from_config(config)
    params, loss = train_decoder(cfg, xyz, feats, num_epochs=num_epochs,
                                 lr=lr, device=device)
    out = os.path.join(save_dir, "train_feat", "ckpt.npz")
    save_params(params, out)
    print(f"final cos loss {loss:.4f}; saved {out}")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--num_epochs", type=int, default=41)
    parser.add_argument("--lr", type=float, default=0.001)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    save_dir = save_dir_for(config)
    os.makedirs(save_dir, exist_ok=True)
    return run(config, save_dir, num_epochs=args.num_epochs, lr=args.lr,
               device=args.device)


if __name__ == "__main__":
    main()
