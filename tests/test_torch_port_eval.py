"""Port parity for evaluation (eval.metrics, eval.selection,
dist.multihost's primary test, data.datasets) against the JAX package on
the same numpy inputs."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from splatloc_tpu.data import datasets as jdatasets
from splatloc_tpu.eval import metrics as jmetrics
from splatloc_tpu.eval import selection as jselection
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.data import datasets as tdatasets
from splatloc_tpu_torch.dist import multihost
from splatloc_tpu_torch.eval import metrics as tmetrics
from splatloc_tpu_torch.eval import selection as tselection

torch.set_num_threads(1)


def _images(seed=0, h=40, w=48):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-0.1, 1.1, (h, w, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    gt[:5] = 0.0                                   # masked pixels
    return img, gt


def test_psnr_masked_matches_jax():
    img, gt = _images()
    j = float(jmetrics.psnr_masked(jnp.asarray(img), jnp.asarray(gt)))
    t = float(tmetrics.psnr_masked(torch.from_numpy(img),
                                   torch.from_numpy(gt)))
    np.testing.assert_allclose(t, j, rtol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_pose_errors_match_jax(seed):
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rng.normal(size=3)).as_matrix()
    gt = np.eye(4)
    gt[:3, :3] = Rotation.from_rotvec(rng.normal(size=3) * 0.01).as_matrix() @ R
    gt[:3, 3] = rng.normal(size=3)
    t = rng.normal(size=3)
    j = jmetrics.pose_errors(R, t, gt)
    p = tmetrics.pose_errors(R, t, gt)
    # rotation: 2 arccos(|q.q'|) in float32 near |q.q'| = 1, where one ulp
    # of the dot moves the angle by up to 2 sqrt(2 * 6e-8) rad = 0.04 deg
    np.testing.assert_allclose(p[0], j[0], rtol=0, atol=0.05)
    assert 0.1 < j[0] < 2.0
    assert p[1] == j[1]


@pytest.fixture(scope="module")
def lpips_params():
    rng = np.random.default_rng(1)
    params, cin = {}, 3
    for i, (cout, k, _, _) in enumerate(jmetrics._ALEX_CFG):
        params[f"conv{i}_w"] = rng.normal(0, 0.05, (k, k, cin, cout)).astype(
            np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.05, cout).astype(np.float32)
        params[f"lin{i}"] = rng.uniform(0, 0.1, cout).astype(np.float32)
        cin = cout
    return params


def test_lpips_matches_jax(lpips_params):
    """LPIPS with random weights carried across (HWIO -> OIHW), 1e-5
    relative; every AlexNet stage to 1e-4."""
    img, gt = _images(2, 64, 64)
    img = np.clip(img, 0, 1)
    jp = {k: jnp.asarray(v) for k, v in lpips_params.items()}
    tp = convert.lpips_from_numpy(lpips_params, device="cpu")
    j = float(jmetrics.lpips_fn(jp)(jnp.asarray(img), jnp.asarray(gt)))
    t = float(tmetrics.lpips_fn(tp)(torch.from_numpy(img),
                                    torch.from_numpy(gt)))
    assert j > 0
    np.testing.assert_allclose(t, j, rtol=1e-5)
    x = np.random.default_rng(3).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    fj = jmetrics._alex_features(jp, jnp.asarray(x))
    ft = tmetrics._alex_features(tp, torch.from_numpy(x).permute(0, 3, 1, 2))
    for a, b in zip(ft, fj):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), atol=1e-4)


def test_lpips_without_weights(tmp_path, lpips_params):
    assert tmetrics.load_lpips_params(str(tmp_path / "none.npz")) is None
    assert np.isnan(tmetrics.lpips_fn(None)(None, None))
    path = str(tmp_path / "lpips_alex.npz")
    np.savez(path, **lpips_params)
    p = tmetrics.load_lpips_params(path, device="cpu")
    assert tuple(p["conv0_w"].shape) == (64, 3, 11, 11)


@pytest.mark.parametrize("case", ["full", "no_counts", "no_lpips"])
def test_reports_byte_identical(tmp_path, case):
    """eval_pose.txt and eval_rendering.txt written by both packages from
    the same numbers are the same bytes."""
    rng = np.random.default_rng(4)
    errs = [list(map(float, rng.uniform(0, 1, 7))) for _ in range(4)]
    counts = {} if case == "no_counts" else dict(n_solved=6, n_failed=1)
    paths = {}
    for name, mod in (("jax", jmetrics), ("port", tmetrics)):
        d = tmp_path / name / "sub"
        mod.write_pose_report(str(d / "eval_pose.txt"), *errs, **counts)
        mod.write_rendering_report(
            str(d / "eval_rendering.txt"), 23.456789, 0.8123,
            None if case == "no_lpips" else 0.1234)
        paths[name] = d
    for f in ("eval_pose.txt", "eval_rendering.txt"):
        a = (paths["jax"] / f).read_bytes()
        assert a == (paths["port"] / f).read_bytes(), f
        assert len(a) > 20
    if case == "no_lpips":
        assert b"UNAVAILABLE" in (paths["port"] / "eval_rendering.txt"
                                  ).read_bytes()


def _selection_inputs(seed=5, n=300, v=6, h=30, w=40):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.8, 0.8, n),
                    rng.uniform(2, 4, n)], -1).astype(np.float32)
    K = np.array([[30.0, 0, 20], [0, 30, 15], [0, 0, 1]])
    w2cs = np.tile(np.eye(4), (v, 1, 1))
    for i in range(v):
        w2cs[i, 0, 3] = 0.1 * i
        a = 0.05 * i
        w2cs[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                           [-np.sin(a), 0, np.cos(a)]]
    depths = rng.uniform(1.8, 4.2, (v, h, w)).astype(np.float32)
    return pts, w2cs, K, depths


def test_saliency_scores_match_jax():
    """Scores within 1e-4 (float32 device sums into float64 host sums)."""
    pts, w2cs, K, depths = _selection_inputs()
    j = jselection.saliency_scores(pts, w2cs, K, depths, view_chunk=4)
    t = tselection.saliency_scores(pts, w2cs, K, depths, view_chunk=4,
                                   device="cpu")
    assert (j > 0).mean() > 0.5
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("num", [10, 50])
def test_select_landmarks_matches_jax(num):
    pts, w2cs, K, depths = _selection_inputs()
    j = jselection.select_landmarks(pts, w2cs, K, depths, num, view_chunk=4)
    t = tselection.select_landmarks(pts, w2cs, K, depths, num, view_chunk=4,
                                    device="cpu")
    np.testing.assert_array_equal(t, j)


def test_saliency_chunk_truncates_like_astype():
    """Pixel indices truncate toward zero (astype(int32)): a point
    projecting to u = -0.5 reads column 0, one at u = 1.7 column 1."""
    pts = torch.tensor([[-0.5, 0.0, 1.0], [1.7, 0.0, 1.0]])
    K = torch.tensor([[1.0, 0, 0], [0, 1, 1.5], [0, 0, 1]])
    depth = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4) + 1.0
    sd, _, cd, _, _ = tselection._saliency_chunk(
        pts, torch.eye(4)[None], K, depth, 4, 3)
    jsd, _, jcd, _, _ = jselection._saliency_chunk(
        jnp.asarray(pts.numpy()), jnp.eye(4)[None], jnp.asarray(K.numpy()),
        jnp.asarray(depth.numpy()), 4, 3)
    np.testing.assert_array_equal(cd.numpy(), np.asarray(jcd))
    np.testing.assert_allclose(sd.numpy(), np.asarray(jsd))


def test_is_primary_without_a_process_group():
    assert multihost.is_primary()
    assert multihost.primary_only(lambda x: x + 1)(1) == 2


def test_dataset_loaders_match_jax(tmp_path):
    """The port's Replica loader reads the same frames as the JAX one
    (PNG decoded by the native library where it is built, else Pillow)."""
    root = tmp_path / "replica" / "room9"
    rng = np.random.default_rng(6)
    for seq, n in (("Sequence_1", 6), ("Sequence_2", 2)):
        for d in ("rgb", "depth"):
            (root / seq / d).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (24, 32, 3)).astype(
                np.uint8)).save(root / seq / "rgb" / f"rgb_{i}.png")
            Image.fromarray(rng.integers(0, 5000, (24, 32)).astype(
                np.uint16)).save(root / seq / "depth" / f"depth_{i}.png")
        poses = np.tile(np.eye(4), (n, 1, 1))
        poses[:, 0, 3] = np.arange(n) * 0.1
        np.savetxt(root / seq / "traj_w_c.txt", poses.reshape(n, 16))
    gen = tmp_path / "gen" / "room9" / "score_map"
    gen.mkdir(parents=True)
    for i in (0, 5):
        np.save(gen / f"rgb_{i}_score.npy",
                rng.uniform(0, 0.01, (24, 32)).astype(np.float32))
    config = {"Dataset": {
        "type": "replica", "dataset_path": str(root),
        "generated_folder": str(tmp_path / "gen"),
        "Calibration": {"fx": 16.0, "fy": 16.0, "cx": 15.5, "cy": 11.5,
                        "width": 32, "height": 24, "depth_scale": 1000.0}}}
    for train in (True, False):
        a = jdatasets.load_dataset(config, train)
        b = tdatasets.load_dataset(config, train)
        assert len(a) == len(b) == (2 if train else 2)
        for i in range(len(a)):
            fa, fb = a.get_frame(i), b.get_frame(i)
            assert set(fa) == set(fb)
            for k, v in fa.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(fb[k], v, err_msg=k)
                else:
                    assert fb[k] == v, k
    np.testing.assert_array_equal(
        tdatasets.load_dataset(config).load_all_depth(),
        jdatasets.load_dataset(config).load_all_depth())
