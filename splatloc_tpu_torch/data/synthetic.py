"""Synthetic Replica-format dataset generator.

Port of ``splatloc_tpu.data.synthetic``: writes a miniature scene to disk in
the on-disk contract of the reference Replica loader (utils/dataset.py:
20-165) plus the generated_folder artifacts (score maps, fused cloud,
retrieval table, query features), so train_gaussians -> train_decoder ->
test can run end to end from files. The scene is a Gaussian cloud rendered
through ``rasterize`` with the JAX package's configuration (the tiled
blend); 3D landmarks carry random unit descriptors that double as the
fused-cloud supervision and the query SuperPoint features.
"""
from __future__ import annotations

import os

import numpy as np
import torch
from PIL import Image

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import rasterize
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene.ply import write_ply


def generate(root: str, n_train: int = 8, n_test: int = 4,
             width: int = 80, height: int = 60, n_gauss: int = 400,
             n_landmarks: int = 60, desc_dim: int = 256, seed: int = 0,
             device="cuda"):
    """Creates {root}/scene and {root}/generated/scene, rendering on
    ``device``. Returns a config dict pointing at them (reference YAML
    schema)."""
    rng = np.random.default_rng(seed)
    scene_dir = os.path.join(root, "scene")
    gen_dir = os.path.join(root, "generated", "scene")
    for sub in ("Sequence_1/rgb", "Sequence_1/depth", "Sequence_2/rgb",
                "Sequence_2/depth"):
        os.makedirs(os.path.join(scene_dir, sub), exist_ok=True)
    for sub in ("score_map", "query_features"):
        os.makedirs(os.path.join(gen_dir, sub), exist_ok=True)

    fx = fy = 0.8 * width
    cx, cy = width / 2, height / 2

    # gt Gaussian cloud in a box in front of the origin
    means = np.stack([rng.uniform(-1.6, 1.6, n_gauss),
                      rng.uniform(-1.2, 1.2, n_gauss),
                      rng.uniform(2.0, 4.5, n_gauss)], -1).astype(np.float32)
    scales = np.full((n_gauss, 3), 0.09, np.float32)
    quats = np.tile(np.array([1, 0, 0, 0], np.float32), (n_gauss, 1))
    opac = np.full((n_gauss,), 0.93, np.float32)
    colors = rng.uniform(0.1, 1.0, (n_gauss, 3)).astype(np.float32)

    landmarks = means[:n_landmarks]
    desc = rng.normal(size=(n_landmarks, desc_dim)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)

    cfg = RasterConfig(tile_chunk=8, max_per_tile=512)
    gauss = [torch.from_numpy(x).to(device)
             for x in (means, scales, quats, opac, colors)]

    def camera(c2w):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        return Camera.create(w2c, fx, fy, cx, cy, width, height,
                             device=device)

    def pose_for(i, n, test=False):
        ang = 0.25 * (i - n / 2) / max(n, 1) + (0.013 if test else 0.0)
        c2w = np.eye(4, dtype=np.float32)
        cth, sth = np.cos(ang), np.sin(ang)
        c2w[:3, :3] = np.array([[cth, 0, sth], [0, 1, 0], [-sth, 0, cth]],
                               np.float32)
        c2w[:3, 3] = [1.2 * np.sin(ang) + (0.03 if test else 0.0),
                      0.05 * (i % 3), 0.4 * (1 - np.cos(ang))]
        return c2w

    def render_frame(c2w):
        cam = camera(c2w)
        with torch.no_grad():
            out = rasterize(*gauss, cam, cfg)
        return out.image.cpu().numpy(), out.depth.cpu().numpy(), cam

    def project(cam, pts):
        uv, z = cam.project(torch.from_numpy(pts).to(device))
        return uv.cpu().numpy(), z.cpu().numpy()

    train_poses, test_poses = [], []
    train_names, test_names = [], []
    for split, n, test in (("Sequence_1", n_train, False),
                           ("Sequence_2", n_test, True)):
        poses = []
        for i in range(n):
            c2w = pose_for(i, n, test)
            poses.append(c2w)
            img, dep, cam = render_frame(c2w)
            name = f"rgb_{i}"
            Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
                os.path.join(scene_dir, split, "rgb", f"rgb_{i}.png"))
            dep_mm = np.clip(dep * 1000, 0, 65535).astype(np.uint16)
            Image.fromarray(dep_mm).save(
                os.path.join(scene_dir, split, "depth", f"depth_{i}.png"))
            if not test:
                train_poses.append(c2w)
                train_names.append(name)
                # score map: landmark projections
                uv, z = project(cam, landmarks)
                score = np.zeros((height, width), np.float32)
                ui = np.round(uv[:, 0]).astype(int)
                vi = np.round(uv[:, 1]).astype(int)
                ok = (z > 0.2) & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
                score[vi[ok], ui[ok]] = 0.9
                np.save(os.path.join(gen_dir, "score_map",
                                     f"{name}_score.npy"), score)
            else:
                test_poses.append(c2w)
                test_names.append(name)
                # query features: visible landmark projections + descriptors
                uv, z = project(cam, landmarks)
                ok = ((z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < width)
                      & (uv[:, 1] >= 0) & (uv[:, 1] < height))
                np.savez(os.path.join(gen_dir, "query_features",
                                      f"{name}.npz"),
                         keypoints=uv[ok].astype(np.float32),
                         descriptors=desc[ok].T.astype(np.float32))
        np.savetxt(os.path.join(scene_dir, split, "traj_w_c.txt"),
                   np.stack(poses).reshape(len(poses), 16))

    # fused cloud artifacts
    write_ply(os.path.join(gen_dir, "sp_inloc_pc.ply"),
              ["x", "y", "z"], landmarks)
    np.save(os.path.join(gen_dir, "sp_inloc_feat.npy"), desc)

    # retrieval: nearest train pose per query, restricted to the frames the
    # loader actually keeps (every 5th, utils/dataset.py train_step=5)
    kept = [j for j in range(len(train_names)) if j % 5 == 0]
    with open(os.path.join(gen_dir, "netvlad_retrieval.txt"), "w") as f:
        for qn, qp in zip(test_names, test_poses):
            d = [np.linalg.norm(qp[:3, 3] - train_poses[j][:3, 3])
                 + np.abs(qp[:3, :3] - train_poses[j][:3, :3]).sum() * 0.1
                 for j in kept]
            order = np.argsort(d)[:5]
            f.write(qn + " " + " ".join(train_names[kept[j]]
                                        for j in order) + "\n")

    lo = means.min(0) - 0.5
    hi = means.max(0) + 0.5
    config = {
        "Results": {"save_results": True,
                    "save_dir": os.path.join(root, "results"),
                    "save_debug": False, "save_match": False,
                    "show_imgwise_error": False},
        "Dataset": {
            "sensor_type": "depth", "type": "replica",
            "dataset_path": scene_dir,
            "generated_folder": os.path.join(root, "generated"),
            "pcd_downsample": 16, "pcd_downsample_init": 8,
            "adaptive_pointsize": True, "point_size": 0.05,
            "Calibration": {"fx": fx, "fy": fy, "cx": cx, "cy": cy,
                            "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0,
                            "k3": 0.0, "width": width, "height": height,
                            "depth_scale": 1000.0, "distorted": False},
        },
        "decoder": {"enc": "HashGrid", "num_layers": 3, "hidden_dim": 64,
                    "final_dim": desc_dim},
        "scene": {"bound": [[float(lo[0]), float(hi[0])],
                            [float(lo[1]), float(hi[1])],
                            [float(lo[2]), float(hi[2])]],
                  "voxel_sdf": 0.1},
        "Training": {"init_itr_num": 100, "mapping_itr_num": 10,
                     "gaussian_update_every": 150,
                     "gaussian_update_offset": 50, "gaussian_th": 0.3,
                     "gaussian_extent": 1.0, "gaussian_reset": 2001,
                     "size_threshold": 20, "kf_interval": 1,
                     "window_size": 3, "edge_threshold": 4,
                     "rgb_boundary_threshold": 0.01,
                     "spherical_harmonics": False, "primitive_reg": True,
                     "lr": {"cam_rot_delta": 0.003,
                            "cam_trans_delta": 0.001}},
        "opt_params": {
            "iterations": 30000, "position_lr_init": 0.00016,
            "position_lr_final": 0.0000016, "position_lr_delay_mult": 0.01,
            "position_lr_max_steps": 30000, "feature_lr": 0.0025,
            "opacity_lr": 0.05, "marker_lr": 0.05, "kp_score_lr": 0.05,
            "descriptor_lr": 0.01, "scaling_lr": 0.001,
            "rotation_lr": 0.001, "percent_dense": 0.01,
            "lambda_dssim": 0.2, "densification_interval": 100,
            "opacity_reset_interval": 3000, "densify_from_iter": 500,
            "densify_until_iter": 15000, "densify_grad_threshold": 0.0002},
        "model_params": {"sh_degree": 0},
        "Eval": {"pnp_inlier_px": 3.0},   # 12px at fx~320 scaled to fx~51
        "pipeline_params": {"convert_SHs_python": True,
                            "compute_cov3D_python": False},
    }
    return config
