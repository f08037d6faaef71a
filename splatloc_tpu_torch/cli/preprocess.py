"""Offline preprocessing pipeline (reference pre_process/, SURVEY.md §3.5).

Port of ``splatloc_tpu.cli.preprocess``, on ``--device`` (CUDA unless the
caller asks for the CPU):

1. extract-features: SuperPoint dense score maps (+ keypoint features for
   queries) into generated_folder/score_map and /query_features
   (pre_process/extract_save_sp_feature.py:236-314).
2. gen-retrieval: NetVLAD global descriptors + top-10 table ->
   netvlad_retrieval.txt (pre_process/gen_netvlad_retrieval.py:44-88).
3. gen-fusion: TSDF feature fusion over train frames -> sp_inloc_pc.ply +
   sp_inloc_feat.npy and mesh.ply
   (pre_process/gen_3d_fusion_feature.py:48-94).

Usage:
  python -m splatloc_tpu_torch.cli.preprocess extract-features \
      --config c.yaml --superpoint weights/superpoint.npz
  python -m splatloc_tpu_torch.cli.preprocess gen-retrieval \
      --config c.yaml --netvlad weights/netvlad.npz
  python -m splatloc_tpu_torch.cli.preprocess gen-fusion \
      --config c.yaml --superpoint weights/superpoint.npz
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from splatloc_tpu_torch.cli.config import load_config


def _gray(rgb: np.ndarray) -> np.ndarray:
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2]).astype(np.float32)


def extract_features(config: dict, sp_weights: str,
                     max_keypoints: int = 4096, device="cuda"):
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.match import superpoint

    params = superpoint.load_params(sp_weights, device)
    for train in (True, False):
        ds = load_dataset(config, train=train)
        ds.load_score_flag = False
        score_dir = os.path.join(ds.generated_folder, "score_map")
        qf_dir = os.path.join(ds.generated_folder, "query_features")
        os.makedirs(score_dir, exist_ok=True)
        os.makedirs(qf_dir, exist_ok=True)
        for i in range(len(ds)):
            name = ds.index_to_name(i)
            gray = torch.as_tensor(_gray(ds.load_image(i)), device=device)
            out = superpoint.extract(params, gray,
                                     max_keypoints=max_keypoints)
            if train:
                np.save(os.path.join(score_dir, f"{name}_score.npy"),
                        out["dense_scores"].cpu().numpy().astype(np.float32))
            else:
                valid = out["valid"].cpu().numpy()
                np.savez(os.path.join(qf_dir, f"{name}.npz"),
                         keypoints=out["keypoints"].cpu().numpy()[valid],
                         descriptors=out["descriptors"].cpu().numpy()[
                             :, valid])
            if i % 50 == 0:
                print(f"[extract] {'train' if train else 'test'} "
                      f"{i}/{len(ds)}", flush=True)


def gen_retrieval(config: dict, nv_weights: str, top_k: int = 10,
                  device="cuda"):
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.match import netvlad

    params = netvlad.load_params(nv_weights, device)
    train = load_dataset(config, train=True)
    test = load_dataset(config, train=False)
    train.load_score_flag = test.load_score_flag = False

    def descs(ds):
        return torch.stack([netvlad.global_descriptor(
            params, torch.as_tensor(ds.load_image(i), device=device))
            for i in range(len(ds))])

    idx, _ = netvlad.top_k_retrieval(descs(test), descs(train),
                                     k=min(top_k, len(train)))
    idx = idx.cpu().numpy()
    out_path = os.path.join(train.generated_folder, "netvlad_retrieval.txt")
    os.makedirs(train.generated_folder, exist_ok=True)
    with open(out_path, "w") as f:
        for i in range(len(test)):
            names = [train.index_to_name(j) for j in idx[i]]
            f.write(test.index_to_name(i) + " " + " ".join(names) + "\n")
    print("wrote", out_path)


def gen_fusion(config: dict, sp_weights: str | None,
               voxel_size: float = 0.02, max_points: int = 500_000,
               feat_dim: int = 256, device="cuda"):
    """TSDF-fuse train frames, extract surface points, fuse dense SuperPoint
    descriptors onto them."""
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.fields import fusion
    from splatloc_tpu_torch.fields import mesh as mesh_mod
    from splatloc_tpu_torch.match import superpoint
    from splatloc_tpu_torch.scene.ply import write_ply

    ds = load_dataset(config, train=True)
    ds.load_score_flag = False
    bound = np.asarray(config["scene"]["bound"], np.float32)
    vol = fusion.TSDFVolume.create(bound, voxel_size, device=device)

    frames = []
    for i in range(len(ds)):
        f = ds.get_frame(i)
        if not f["valid"]:
            continue
        vol = fusion.integrate_frame(vol, f["depth"], f["rgb"], ds.K,
                                     f["c2w"])
        frames.append(i)
        if i % 50 == 0:
            print(f"[fusion] integrate {i}/{len(ds)}", flush=True)

    points, colors = fusion.extract_surface_points(vol, max_points)
    print(f"[fusion] {points.shape[0]} surface points")

    params = (superpoint.load_params(sp_weights, device) if sp_weights
              else None)

    def frame_feats():
        for i in frames:
            f = ds.get_frame(i)
            H, W = f["depth"].shape
            if params is not None:
                gray = torch.as_tensor(_gray(f["rgb"]), device=device)
                _, coarse = superpoint.dense_outputs(params, gray)
                # the coarse map upsampled x8 (nearest), on the device
                dense = coarse.repeat_interleave(8, 0).repeat_interleave(
                    8, 1)[:H, :W]
            else:
                dense = ds.load_sp_feat(i)   # precomputed .pt
            yield dense, f["depth"], f["c2w"]

    feats, weight = fusion.fuse_point_features(points, frame_feats(), ds.K,
                                               feat_dim, device=device)
    keep = weight > 0
    points, feats = points[keep], feats[keep]

    os.makedirs(ds.generated_folder, exist_ok=True)
    write_ply(os.path.join(ds.generated_folder, "sp_inloc_pc.ply"),
              ["x", "y", "z"], points)
    np.save(os.path.join(ds.generated_folder, "sp_inloc_feat.npy"), feats)
    print(f"wrote fused cloud: {points.shape[0]} pts")

    # mesh.ply artifact (reference gen_3d_fusion_feature.py:73,91-92)
    verts, faces, norms, vcols = mesh_mod.get_mesh(vol)
    mesh_path = os.path.join(ds.generated_folder, "mesh.ply")
    mesh_mod.save_mesh_ply(mesh_path, verts, faces, norms, vcols)
    print(f"wrote {mesh_path}: {verts.shape[0]} verts {faces.shape[0]} faces")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["extract-features",
                                            "gen-retrieval", "gen-fusion"])
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--superpoint", type=str, default=None)
    parser.add_argument("--netvlad", type=str, default=None)
    parser.add_argument("--voxel_size", type=float, default=0.02)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    config = load_config(args.config)
    if args.command == "extract-features":
        extract_features(config, args.superpoint, device=args.device)
    elif args.command == "gen-retrieval":
        gen_retrieval(config, args.netvlad, device=args.device)
    elif args.command == "gen-fusion":
        gen_fusion(config, args.superpoint, voxel_size=args.voxel_size,
                   device=args.device)


if __name__ == "__main__":
    main()
