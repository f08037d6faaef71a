"""Port parity for the mapping CLI and the dataset writer: data.synthetic's
``generate`` and cli.train_gaussians' ``run`` of both packages on the same
inputs, then the port's EvalSession localizing from the port's map. Both
packages take the tiled blend on the CPU. The keyframe downsampling draws
(JAX PRNG streams) are injected into the port's trainer."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from splatloc_tpu.cli import train_gaussians as jtg
from splatloc_tpu.data import synthetic as jsynth
from splatloc_tpu.scene import ply as jply
from splatloc_tpu_torch.cli import test as tcli
from splatloc_tpu_torch.cli import train_gaussians as ttg
from splatloc_tpu_torch.cli.config import save_dir_for
from splatloc_tpu_torch.data import synthetic as tsynth
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene import init_rgbd as tinit
from splatloc_tpu_torch.scene import ply as tply

torch.set_num_threads(1)

W, H = 64, 48
GEN = dict(n_train=6, n_test=3, width=W, height=H, n_gauss=250,
           n_landmarks=40, desc_dim=64, seed=0)
# share of pixels allowed to differ by more than one level in a written PNG
# (a pixel whose blend flips at the alpha_min cut between the two builds)
PNG_FLIP_SHARE = 0.002


def _files(root):
    out = set()
    for d, _, names in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, n), root) for n in names}
    return out


def _strip_root(x, root):
    if isinstance(x, dict):
        return {k: _strip_root(v, root) for k, v in x.items()}
    if isinstance(x, str):
        return x.replace(root, "<root>")
    return x


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    roots = {}
    for name, gen, kw in (("jax", jsynth.generate, {}),
                          ("port", tsynth.generate, {"device": "cpu"})):
        root = str(tmp_path_factory.mktemp(name))
        roots[name] = (root, gen(root, **GEN, **kw))
    return roots


def test_generate_matches_jax(generated):
    """The same file set and config dict; PNGs within one level on all but
    PNG_FLIP_SHARE of the pixels (depth within 1 mm); score maps, query
    keypoints (1e-4), descriptors, trajectories, the fused cloud and the
    retrieval table as the JAX package writes them."""
    (jroot, jcfg), (troot, tcfg) = generated["jax"], generated["port"]
    files = _files(jroot)
    assert files == _files(troot) and len(files) > 20
    assert _strip_root(jcfg, jroot) == _strip_root(tcfg, troot)
    for f in sorted(files):
        a, b = os.path.join(jroot, f), os.path.join(troot, f)
        if f.endswith(".png"):
            x = np.asarray(Image.open(a)).astype(np.int64)
            y = np.asarray(Image.open(b)).astype(np.int64)
            assert x.shape == y.shape and x.dtype == y.dtype, f
            assert (np.abs(x - y) > 1).mean() <= PNG_FLIP_SHARE, f
        elif f.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            np.testing.assert_allclose(y["keypoints"], x["keypoints"],
                                       rtol=0, atol=1e-4, err_msg=f)
            np.testing.assert_array_equal(y["descriptors"], x["descriptors"])
        elif f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(b), np.load(a), err_msg=f)
        else:   # traj_w_c.txt, netvlad_retrieval.txt, sp_inloc_pc.ply
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), f


def _jax_draws(n_keyframes, H, W, seed=0):
    """The JAX trainer's keyframe priorities: PRNGKey(seed) split once per
    keyframe (train/mapping.py:_next_rng), one uniform draw per pixel."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_keyframes):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.uniform(k, (H * W,))))
    return out


RUN = dict(capacity=4096, refinement_iters=4, log_every=1)


@pytest.fixture(scope="module")
def mapped(generated, tmp_path_factory):
    """Both packages' run() on the JAX-written dataset (2 kept keyframes x
    4 mapping iterations, 4 refinement iterations), each into its own save
    directory; the port given the JAX trainer's draws."""
    root, config = generated["jax"]
    config = dict(config, Training=dict(config["Training"],
                                        mapping_itr_num=4))
    draws = [torch.from_numpy(d.copy()) for d in _jax_draws(2, H, W)]
    add_frame = tinit.add_frame

    def injected(*a, **kw):
        return add_frame(*a, priorities=draws.pop(0), **kw)
    out = {}
    for name, run, kw in (("jax", jtg.run, {}),
                          ("port", ttg.run, {"device": "cpu"})):
        save_dir = str(tmp_path_factory.mktemp(f"map_{name}"))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(tinit, "add_frame", injected)
            path = run(config, save_dir, **RUN, **kw)
        with open(os.path.join(save_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        out[name] = (path, recs, save_dir)
    assert not draws
    return config, out


# relative L2 of the port's map against the JAX package's after 8 mapping
# and 4 refinement steps, per attribute (measured: <= 2.6e-6). The
# quaternions are held as one block: a keyframe's Gaussians start isotropic
# (equal scales), where the rotation's true gradient is 0, so Adam's
# normalised step moves a component by +-lr in the sign of float noise (a
# few Gaussians of 415, up to 4e-3 in one component; the block 3.4e-4)
MAP_REL_L2 = 1e-5
QUAT_REL_L2 = 1e-3
TIMING_KEYS = {"t", "it_per_s", "wall_s"}


def test_run_matches_jax(mapped):
    """The saved PLYs: the same path layout, alive count and attribute
    names, every attribute within MAP_REL_L2 and the quaternions within
    QUAT_REL_L2; metrics.jsonl: the same records and keys, every value but
    the timings equal, the losses within 1e-5 relative."""
    _, out = mapped
    (jpath, jrecs, jdir), (tpath, trecs, tdir) = out["jax"], out["port"]
    assert os.path.relpath(jpath, jdir) == os.path.relpath(tpath, tdir) \
        == os.path.join("point_cloud", "final", "point_cloud.ply")
    jv, tv = jply.read_ply_vertices(jpath), tply.read_ply_vertices(tpath)
    assert list(jv) == list(tv)
    assert jv["x"].shape == tv["x"].shape and jv["x"].shape[0] > 100
    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    for k in jv:
        if not k.startswith("rot_"):
            r = rel(tv[k].astype(np.float64), jv[k].astype(np.float64))
            assert r <= MAP_REL_L2, (k, r)
    quats = [np.stack([v[f"rot_{i}"] for i in range(4)], -1).astype(
        np.float64) for v in (tv, jv)]
    assert rel(*quats) <= QUAT_REL_L2, rel(*quats)
    assert len(trecs) == len(jrecs) == 3
    for a, b in zip(trecs, jrecs):
        assert set(a) == set(b)
        for k in set(b) - TIMING_KEYS:
            if k == "loss":
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5)
            else:
                assert a[k] == b[k], k
    assert trecs[-1]["phase"] == "refined"


def test_port_map_localizes(mapped):
    """The port's EvalSession, on the CPU, localizes the queries from the
    port's map: a decoder written here, and query features made as
    tests/test_torch_port_localize.py makes them, at the map's own key
    Gaussians (the decoder is random, not trained on the landmarks)."""
    from splatloc_tpu_torch.core.camera import Camera
    from splatloc_tpu_torch.fields import (FeatureFieldConfig, decode,
                                           init_decoder)
    from splatloc_tpu_torch.train.decoder_train import save_params
    config, out = mapped
    save_dir = out["port"][2]
    fcfg = FeatureFieldConfig.from_config(config)
    params = init_decoder(fcfg, torch.Generator().manual_seed(1),
                          device="cpu")
    save_params(params, os.path.join(save_dir, "train_feat", "ckpt.npz"))
    v = tply.read_ply_vertices(out["port"][0])
    keys = np.stack([v["x"], v["y"], v["z"]], -1)[v["marker"] > 0.005]
    assert len(keys) >= 20
    cal = config["Dataset"]["Calibration"]
    qposes = np.loadtxt(os.path.join(config["Dataset"]["dataset_path"],
                                     "Sequence_2", "traj_w_c.txt"))
    qf_dir = os.path.join(config["Dataset"]["generated_folder"], "scene",
                          "query_features")
    rng = np.random.default_rng(3)
    for i, c2w in enumerate(qposes.reshape(-1, 4, 4)):
        cam = Camera.create(np.linalg.inv(c2w).astype(np.float32),
                            cal["fx"], cal["fy"], cal["cx"], cal["cy"], W, H,
                            device="cpu")
        uv, z = (x.numpy() for x in cam.project(torch.from_numpy(keys)))
        ok = ((z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
              & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        desc = decode(params, torch.from_numpy(keys[ok]), fcfg).numpy()
        desc = desc + rng.normal(0, 0.02, desc.shape)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        np.savez(os.path.join(qf_dir, f"rgb_{i}.npz"),
                 keypoints=uv[ok].astype(np.float32),
                 descriptors=desc.T.astype(np.float32))
    session = tcli.EvalSession(config, save_dir, device="cpu")
    assert session.raster_cfg == RasterConfig.for_device("cpu")
    assert not session.raster_cfg.use_pallas
    m_t, m_r = session.eval_pose()
    assert len(m_t) == 3
    with open(os.path.join(save_dir, "eval_pose.txt")) as f:
        report = f.read()
    assert "Solved: 3." in report, report
    assert np.median(m_t) < 0.02 and np.median(m_r) < 1.0, (m_t, m_r)


def test_main_writes_config_and_map(generated, tmp_path):
    """main(): the merged config dumped to <save_dir>/config.yml, the map
    at the reference path, --max_frames honoured."""
    import yaml
    root, config = generated["port"]
    config = dict(config, Results=dict(config["Results"],
                                       save_dir=str(tmp_path / "results")),
                  Training=dict(config["Training"], mapping_itr_num=1))
    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:
        yaml.dump(config, f)
    out = ttg.main(["--config", path, "--max_frames", "1",
                    "--refinement_iters", "1", "--capacity", "2048",
                    "--device", "cpu"])
    save_dir = save_dir_for(config)
    assert out == os.path.join(save_dir, "point_cloud", "final",
                               "point_cloud.ply")
    with open(os.path.join(save_dir, "config.yml")) as f:
        assert yaml.safe_load(f) == config
    recs = [json.loads(x) for x in open(os.path.join(save_dir,
                                                     "metrics.jsonl"))]
    assert [r.get("kf") for r in recs] == [0, None]
    scene = tply.load_scene(out, device="cpu")
    assert int(scene.num_alive) > 0
