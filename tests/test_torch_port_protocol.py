"""The port's full protocol through every CLI's ``main`` on the CPU (the
counterpart of tests/test_cli_protocol.py, reference replica.sh):

    preprocess extract-features / gen-retrieval / gen-fusion
    -> train_gaussians -> train_decoder
    -> test --eval_pose --eval_rendering --eval_selection --save_pose
       --save_match -> replay

on a 64x48 Replica-format dataset from the port's ``data.synthetic`` and
random SuperPoint and NetVLAD weights written in the JAX package's npz
layout. It pins the artifact contract: every file exists and parses, the
medians are finite and the rendering's PSNR is above 10 dB. Accuracy is
not asserted (random descriptors carry no metric space). Depth is cut so
the whole run stays well under a minute.
"""
import os
import re

import numpy as np
import torch
import yaml
from PIL import Image

from splatloc_tpu_torch.cli import preprocess, replay, train_decoder
from splatloc_tpu_torch.cli import test as cli_test
from splatloc_tpu_torch.cli import train_gaussians
from splatloc_tpu_torch.cli.config import save_dir_for
from splatloc_tpu_torch.data import synthetic
from splatloc_tpu_torch.fields import mesh
from splatloc_tpu_torch.match import netvlad, superpoint
from splatloc_tpu_torch.scene.ply import read_ply_vertices

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def _hwio_npz(path, params):
    """Port params (OIHW) saved in the JAX package's npz layout (HWIO)."""
    np.savez(path, **{k: (v.permute(2, 3, 1, 0) if v.ndim == 4 else v)
                      .numpy() for k, v in params.items()})


def _parse_pose_report(path):
    with open(path) as f:
        txt = f.read()
    flat = [float(x) for pair in re.findall(
        r"Trans\.\(cm\): ([-\d.e+]+)\. Rotation\(deg\): ([-\d.e+]+)\.", txt)
        for x in pair]
    assert len(flat) == 4, txt
    return flat


def test_full_cli_protocol(tmp_path):
    root = str(tmp_path)
    config = synthetic.generate(root, n_train=6, n_test=2, width=64,
                                height=48, n_gauss=200, n_landmarks=30,
                                desc_dim=256, device="cpu")
    # depth cut for the CPU: 2 keyframes x 2 iterations
    config["Training"]["init_itr_num"] = 2
    config["Training"]["mapping_itr_num"] = 2
    cfg_path = os.path.join(root, "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(config, f)
    sp_path = os.path.join(root, "superpoint.npz")
    nv_path = os.path.join(root, "netvlad.npz")
    _hwio_npz(sp_path, superpoint.init_params(
        torch.Generator().manual_seed(0), device="cpu"))
    nv = netvlad.init_params(torch.Generator().manual_seed(1), whiten_dim=32,
                             device="cpu")
    _hwio_npz(nv_path, nv)

    preprocess.main(["extract-features", "--config", cfg_path,
                     "--superpoint", sp_path] + CPU)
    preprocess.main(["gen-retrieval", "--config", cfg_path,
                     "--netvlad", nv_path] + CPU)
    preprocess.main(["gen-fusion", "--config", cfg_path, "--superpoint",
                     sp_path, "--voxel_size", "0.08"] + CPU)
    gen = os.path.join(root, "generated", "scene")
    with open(os.path.join(gen, "netvlad_retrieval.txt")) as f:
        table = [line.split() for line in f.read().splitlines()]
    assert [row[0] for row in table] == ["rgb_0", "rgb_1"]
    assert all(len(row) == 3 for row in table)       # 2 kept train frames
    for name in ("rgb_0", "rgb_5"):
        score = np.load(os.path.join(gen, "score_map", f"{name}_score.npy"))
        assert score.shape == (48, 64) and np.isfinite(score).all()
    qf = np.load(os.path.join(gen, "query_features", "rgb_0.npz"))
    assert qf["descriptors"].shape == (256, qf["keypoints"].shape[0])
    v = read_ply_vertices(os.path.join(gen, "sp_inloc_pc.ply"))
    feats = np.load(os.path.join(gen, "sp_inloc_feat.npy"))
    assert feats.shape == (len(v["x"]), 256) and len(v["x"]) > 100
    # each an average of unit descriptors over the frames that see it
    norms = np.linalg.norm(feats, axis=1)
    assert (norms <= 1.0 + 1e-5).all() and (norms > 0.5).all()
    verts, faces, _, _ = mesh.load_mesh_ply(os.path.join(gen, "mesh.ply"))
    assert faces.shape[0] > 100 and faces.max() < verts.shape[0]

    train_gaussians.main(["--config", cfg_path, "--capacity", "4096",
                          "--refinement_iters", "4"] + CPU)
    save_dir = save_dir_for(config)
    assert os.path.exists(os.path.join(save_dir, "point_cloud", "final",
                                       "point_cloud.ply"))
    ckpt = train_decoder.main(["--config", cfg_path, "--num_epochs", "2"]
                              + CPU)
    assert ckpt == os.path.join(save_dir, "train_feat", "ckpt.npz")

    cli_test.main(["--config", cfg_path, "--eval_pose", "--eval_rendering",
                   "--eval_selection", "--landmark_num", "20",
                   "--save_pose", "--save_match"] + CPU)
    pose_file = os.path.join(save_dir, "eval_pose.txt")
    sel_file = os.path.join(save_dir, "eval_selection_20.txt")
    for p in (pose_file, sel_file):
        assert all(np.isfinite(x) for x in _parse_pose_report(p)), p
    with open(os.path.join(save_dir, "eval_rendering.txt")) as f:
        txt = f.read()
    psnr = float(re.search(r"mean_psnr: ([-\d.e+]+)", txt).group(1))
    assert np.isfinite(psnr) and psnr > 10.0, txt
    assert np.isfinite(float(re.search(r"mean_ssim: ([-\d.e+]+)",
                                       txt).group(1)))
    assert "mean_lpips:" in txt
    pdir = os.path.join(save_dir, "save_pose")
    assert np.load(os.path.join(pdir, "gt.npy")).shape == (2, 4, 4)
    assert sorted(os.listdir(os.path.join(save_dir, "save_match"))) == [
        "rgb_0.npy", "rgb_1.npy"]

    out = os.path.join(save_dir, "replay3d")
    # every query kept: random weights localize far from the truth
    replay.main(["--save_dir", save_dir, "--mesh",
                 os.path.join(gen, "mesh.ply"), "--out", out, "--width",
                 "96", "--height", "72", "--max_dist", "1000"])
    frames = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert frames == ["frame_00000.png", "frame_00001.png"]
    img = np.asarray(Image.open(os.path.join(out, frames[1])))
    assert img.shape == (72, 96, 3) and img.any()
