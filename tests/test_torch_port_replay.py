"""Port parity for the offscreen 3-D localization replay: ``eval.replay3d``
frames and ``cli.replay`` against the JAX package on the same mesh, poses
and match dumps (numpy and PIL on both sides: identical images)."""
import os

import numpy as np
import pytest
from PIL import Image

from splatloc_tpu.cli import replay as jreplay_cli
from splatloc_tpu.eval import replay3d as jreplay
from splatloc_tpu_torch.cli import replay as treplay_cli
from splatloc_tpu_torch.eval import replay3d as treplay
from splatloc_tpu_torch.fields.mesh import save_mesh_ply

K = np.array([[200.0, 0, 160], [0, 200.0, 120], [0, 0, 1]], np.float32)


def _sphere_mesh(n=800, r=1.0):
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    return (v * r).astype(np.float32), v, np.full((n, 3), 200, np.uint8)


def _poses(n=4):
    out = []
    for i in range(n):
        ang = 0.3 * i
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 3] = [2.5 * np.sin(ang), 0.0, -2.5 * np.cos(ang)]
        out.append(c2w)
    return np.stack(out)


@pytest.mark.parametrize("with_matches", [False, True])
def test_replay3d_frame_matches_jax(with_matches):
    verts, normals, colors = _sphere_mesh()
    gt = _poses()
    pred = gt.copy()
    pred[:, 0, 3] += 0.15
    w2c = jreplay.look_at_viewpoint(np.zeros(3, np.float32), 6.0)
    np.testing.assert_array_equal(
        treplay.look_at_viewpoint(np.zeros(3, np.float32), 6.0), w2c)
    matches = ({"pt3d": verts[:20], "kp2d": np.tile([160.0, 120.0], (20, 1))}
               if with_matches else None)
    for mesh in ((verts, normals, None), (verts, None, colors / 255.0)):
        j = jreplay.replay3d_frame(mesh, K, w2c, 320, 240, gt, pred, 2,
                                   matches=matches, K_query=K)
        t = treplay.replay3d_frame(mesh, K, w2c, 320, 240, gt, pred, 2,
                                   matches=matches, K_query=K)
        assert t.shape == (240, 320, 3) and t.dtype == np.uint8
        np.testing.assert_array_equal(t, j)
        assert t.any()


def test_replay_cli_matches_jax(tmp_path):
    """Both CLIs on one save_pose/ + save_match/ layout (as cli/test.py
    --save_pose --save_match writes it): the same frames kept, the same
    PNGs."""
    verts, normals, colors = _sphere_mesh()
    mesh_path = str(tmp_path / "mesh.ply")
    save_mesh_ply(mesh_path, verts, np.zeros((1, 3), np.int64), normals,
                  colors)
    gt = _poses(4)
    pred = gt.copy()
    pred[:, 0, 3] += 0.02          # within the outlier gate
    pred[3, 0, 3] += 5.0           # one outlier to filter
    pdir = tmp_path / "save_pose"
    pdir.mkdir()
    np.save(pdir / "gt.npy", gt)
    np.save(pdir / "match_r.npy", pred[:, :3, :3])
    np.save(pdir / "match_t.npy", pred[:, :3, 3])
    mdir = tmp_path / "save_match"
    mdir.mkdir()
    for q in range(4):
        np.save(mdir / f"rgb_{q}.npy",
                {"success": True, "2d": np.tile([160.0, 120.0], (5, 1)),
                 "3d": verts[5 * q:5 * q + 5]})
    for name, cli in (("jax", jreplay_cli), ("port", treplay_cli)):
        cli.main(["--save_dir", str(tmp_path), "--mesh", mesh_path,
                  "--out", str(tmp_path / name), "--width", "160",
                  "--height", "120"])
    frames = sorted(os.listdir(tmp_path / "jax"))
    assert [f for f in frames if f.endswith(".png")] == [
        f"frame_{i:05d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "port")) == frames
    for f in frames:
        if f.endswith(".png"):
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "port" / f)),
                np.asarray(Image.open(tmp_path / "jax" / f)))


def test_filter_outliers_and_pose_mats_match_jax():
    rng = np.random.default_rng(2)
    r = rng.normal(size=(6, 3, 3)).astype(np.float32)
    t = rng.normal(size=(6, 3)).astype(np.float32)
    np.testing.assert_array_equal(treplay_cli._pose_mats(r, t),
                                  jreplay_cli._pose_mats(r, t))
    gt = treplay_cli._pose_mats(r, t)
    pred = gt.copy()
    pred[:, 0, 3] += np.linspace(0, 0.2, 6)
    np.testing.assert_array_equal(
        treplay_cli.filter_outliers(pred, gt, 0.1),
        jreplay_cli.filter_outliers(pred, gt, 0.1))
