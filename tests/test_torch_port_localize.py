"""Port parity for localization (match.localize's refinement pieces and
Localizer, cli.test's EvalSession) against the JAX package on the same
numpy inputs. The refinement pieces run the pair path on both sides (the
JAX Pallas path in interpret mode, the port's plain versions: both passed
``use_pallas=True``); the JAX ``refine_pose`` takes the tiled blend on the
CPU (localize.py:323), and the port's is given the pair path, so those two
are held to pose tolerances."""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.cli import test as jcli
from splatloc_tpu.core import transforms as jt
from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.data import synthetic
from splatloc_tpu.fields import decoder as jdecoder
from splatloc_tpu.match import localize as jloc
from splatloc_tpu.raster import RasterConfig as JRasterConfig
from splatloc_tpu.raster import render as jrender
from splatloc_tpu.scene.gaussians import GaussianScene as JScene
from splatloc_tpu.train import decoder_train as jdtrain
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.cli import test as tcli
from splatloc_tpu_torch.cli.config import save_dir_for
from splatloc_tpu_torch.core import transforms as tt
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.match import localize as tloc
from splatloc_tpu_torch.raster.types import RasterConfig as TRasterConfig
from splatloc_tpu_torch.scene import ply as tply
from splatloc_tpu_torch.scene.gaussians import GaussianScene as TScene

torch.set_num_threads(1)

W, H = 64, 48
FX, CX, CY = 50.0, 31.5, 23.5
# the port's pair path on the CPU (the kernels' plain versions)
PAIR = TRasterConfig(use_pallas=True)


def _jax_scene(seed=0, n=220, cap=256):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.9, 0.9, n),
                    rng.uniform(2.0, 5.0, n)], -1).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    s = JScene.empty(cap)
    return s.replace(
        xyz=s.xyz.at[:n].set(xyz),
        scaling=s.scaling.at[:n].set(
            rng.uniform(-3.2, -2.4, (n, 3)).astype(np.float32)),
        rotation=s.rotation.at[:n].set(quats),
        opacity=s.opacity.at[:n].set(2.0),
        f_dc=s.f_dc.at[:n].set(
            ((colors - 0.5) / 0.28209479177387814)[:, None, :]),
        alive=s.alive.at[:n].set(True))


@pytest.fixture(scope="module")
def pair():
    """A JAX scene, its port copy, both cameras at 64x48 and the target
    image rendered at the identity pose (pair path, interpret mode)."""
    js = _jax_scene()
    ts = convert.scene_from_numpy(
        {k: np.array(getattr(js, k)) for k in JScene.PARAM_FIELDS
         + ("alive",)}, 0, device="cpu")
    jcam = JCamera.create(np.eye(4, dtype=np.float32), FX, FX, CX, CY, W, H)
    tcam = TCamera.create(np.eye(4, dtype=np.float32), FX, FX, CX, CY, W, H,
                          device="cpu")
    gt = np.array(jrender(js, jcam, JRasterConfig(use_pallas=True))["render"])
    return js, ts, jcam, tcam, gt


def _w2c(xi):
    return np.array(jt.se3_exp(jnp.asarray(xi, jnp.float32)))


def _pose_err(a, b):
    """(camera-centre distance, rotation angle in degrees)."""
    dR = a[:3, :3] @ b[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    ca = -a[:3, :3].T @ a[:3, 3]
    cb = -b[:3, :3].T @ b[:3, 3]
    return float(np.linalg.norm(ca - cb)), float(ang)


@pytest.mark.parametrize("case", ["to_cap", "patience"])
def test_refine_level_matches_jax(pair, case):
    """One pyramid level against _refine_pose_jit(use_pallas=True): the
    same iteration count, loss0 within 1e-6 and the best loss within 1e-4
    relative (or 2e-7 absolute: the port's render agrees with the JAX
    package's to ~1e-7 in the mean, ROADMAP C), xi within 1e-4 (5 % of one
    Adam step of lr 2e-3). "to_cap"
    runs to the iteration cap; "patience" starts at the target's pose, so
    no step improves and both stop after `patience` iterations."""
    js, ts, jcam, tcam, gt = pair
    if case == "to_cap":
        xi0, iters, patience = [0.02, -0.015, 0.01, 0.01, -0.012, 0.008], 6, 8
    else:
        xi0, iters, patience = [0.0] * 6, 20, 2
    w2c0 = _w2c(xi0)
    xj, ij = jloc._refine_pose_jit(js, jcam, jnp.asarray(w2c0),
                                   jnp.asarray(gt), iters, 2e-3, 1e-4,
                                   patience, True)
    xt, it = tloc._refine_level(ts, tcam, torch.from_numpy(w2c0),
                                torch.from_numpy(gt), iters, 2e-3, 1e-4,
                                patience, PAIR)
    assert it["iters"] == float(ij["iters"])
    assert it["iters"] == (iters if case == "to_cap" else patience + 1)
    np.testing.assert_allclose(float(it["loss0"]), float(ij["loss0"]),
                               rtol=1e-6, atol=2e-7)
    np.testing.assert_allclose(float(it["loss"]), float(ij["loss"]),
                               rtol=1e-4, atol=2e-7)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0, atol=1e-4)
    # one host read of the stop test per iteration (the last one, which
    # stops the loop, included where patience stops it)
    assert it["syncs"] == it["iters"] + (case == "patience")


def test_seed_losses_match_jax(pair):
    """The multi-start seed scoring against _seed_losses_jit(use_pallas=
    True) at the coarse level (32x24), to 1e-6 relative or 2e-7 absolute
    (the render parity floor, as above)."""
    js, ts, jcam, tcam, gt = pair
    jc, jg = jloc._level_cam_gt(jcam, jnp.asarray(gt), 2)
    tc, tg = tloc._level_cam_gt(tcam, torch.from_numpy(gt), 2)
    th = np.radians(7.0)
    xis = np.zeros((5, 6), np.float32)
    for k in range(4):
        a = np.pi * k / 2
        xis[1 + k, 3:5] = th * np.cos(a), th * np.sin(a)
    w2c0 = _w2c([0.01, 0.0, -0.01, 0.0, 0.01, 0.0])
    lj = np.asarray(jloc._seed_losses_jit(js, jc, jnp.asarray(xis),
                                          jnp.asarray(w2c0), jg, True))
    lt = tloc._seed_losses(ts, tc, torch.from_numpy(xis),
                           torch.from_numpy(w2c0), tg, PAIR).numpy()
    assert lt.shape == (5,)
    np.testing.assert_allclose(lt, lj, rtol=1e-6, atol=2e-7)
    lp = float(tloc._pose_loss(ts, tc, torch.from_numpy(w2c0), tg, PAIR))
    np.testing.assert_allclose(lp, float(jloc._pose_loss_jit(
        js, jc, jnp.asarray(w2c0), jg, True)), rtol=1e-6, atol=2e-7)


@pytest.mark.parametrize("s", [1, 2, 4])
def test_level_cam_gt_matches_jax(s):
    rng = np.random.default_rng(s)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    w2c = _w2c([0.1, 0.0, 0.2, 0.05, 0.0, -0.03])
    jc, jg = jloc._level_cam_gt(
        JCamera.create(w2c, FX, FX * 1.1, CX, CY, W, H), jnp.asarray(gt), s)
    tc, tg = tloc._level_cam_gt(
        TCamera.create(w2c, FX, FX * 1.1, CX, CY, W, H, device="cpu"),
        torch.from_numpy(gt), s)
    assert (tc.width, tc.height) == (jc.width, jc.height) == (W // s, H // s)
    for k in ("fx", "fy", "cx", "cy", "w2c"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(),
                                      np.asarray(getattr(jc, k)), err_msg=k)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0, atol=1e-6)


def test_refine_pose_matches_jax(pair):
    """Whole refine_pose (multi-start seeds at the coarsest level, the
    pyramid 2 -> 1, the guard): the port's refined pose within 1 mm and
    0.05 deg of the JAX package's (its blend path on the CPU), the same
    seed count, and both closer to the target's pose than the start."""
    js, ts, jcam, tcam, gt = pair
    w2c0 = _w2c([0.03, -0.02, 0.02, 0.02, -0.03, 0.01])
    xj, ij = jloc.refine_pose(js, jcam, w2c0, gt, iters=30)
    xt, it = tloc.refine_pose(ts, tcam, w2c0, torch.from_numpy(gt), iters=30,
                              raster_cfg=PAIR)
    pj = _w2c(np.asarray(xj)) @ w2c0
    pt = tt.se3_exp(xt).numpy() @ w2c0
    d, a = _pose_err(pt, pj)
    assert d < 1e-3 and a < 0.05, (d, a)
    assert it["seed_evals"] == int(ij["seed_evals"]) == 17
    assert [r["scale"] for r in it["levels"]] == [2, 1]
    assert it["iters"] == sum(r["iters"] for r in it["levels"])
    assert it["syncs"] >= it["iters"] + 2
    start = _pose_err(w2c0, np.eye(4))
    end = _pose_err(pt, np.eye(4))
    assert end[0] < start[0] and end[1] < start[1] / 2, (start, end)
    assert not it["guard_kept_start"]


def test_refine_pose_guard_keeps_a_perfect_start(pair):
    """At the target's own pose nothing scores better at full resolution:
    the guard returns a zero update."""
    _, ts, _, tcam, gt = pair
    xt, it = tloc.refine_pose(ts, tcam, np.eye(4, dtype=np.float32),
                              torch.from_numpy(gt), iters=4,
                              multi_start_deg=(), raster_cfg=PAIR)
    if it["guard_kept_start"]:
        assert float(xt.abs().max()) == 0.0
        assert float(it["loss"]) == float(it["loss0"])
    else:
        assert float(it["loss"]) < float(tloc._pose_loss(
            ts, tcam, torch.eye(4), torch.from_numpy(gt), PAIR))


# --------------------------------------------------------------------------
# EvalSession.eval_pose end to end
# --------------------------------------------------------------------------

def _synthetic_means(seed, n_gauss):
    """generate()'s Gaussian cloud: its first draws from the same rng."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.6, 1.6, n_gauss),
                      rng.uniform(-1.2, 1.2, n_gauss),
                      rng.uniform(2.0, 4.5, n_gauss)], -1).astype(np.float32)
    colors = rng.uniform(0.1, 1.0, (n_gauss, 3)).astype(np.float32)
    return means, colors


@pytest.fixture(scope="module")
def session_dir(tmp_path_factory):
    """A tiny Replica-format dataset from the JAX generator, a map of its
    Gaussians (the landmarks as key Gaussians), a decoder made here, and
    query features whose descriptors are the decoder's at the visible
    landmarks plus noise."""
    root = str(tmp_path_factory.mktemp("synth"))
    n_gauss, n_lm = 250, 40
    config = synthetic.generate(root, n_train=6, n_test=3, width=W,
                                height=H, n_gauss=n_gauss, n_landmarks=n_lm,
                                desc_dim=64, seed=0)
    save_dir = save_dir_for(config)
    means, colors = _synthetic_means(0, n_gauss)
    marker = np.zeros((n_gauss, 1), np.float32)
    marker[:n_lm] = 0.9
    op = 0.93
    scene = TScene(
        xyz=torch.from_numpy(means),
        f_dc=torch.from_numpy(((colors - 0.5) / 0.28209479177387814)
                              [:, None, :]),
        f_rest=torch.zeros((n_gauss, 0, 3)),
        scaling=torch.full((n_gauss, 3), float(np.log(0.09))),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n_gauss, 1),
        opacity=torch.full((n_gauss, 1), float(np.log(op / (1 - op)))),
        marker=torch.from_numpy(marker), kp_score=torch.zeros((n_gauss, 1)),
        alive=torch.ones((n_gauss,), dtype=torch.bool), sh_degree=0)
    tply.save_scene(scene, os.path.join(save_dir, "point_cloud", "final",
                                        "point_cloud.ply"))

    fcfg = jdecoder.FeatureFieldConfig.from_config(config)
    params = jdecoder.init_decoder(fcfg, jax.random.PRNGKey(1))
    table = np.random.default_rng(2).uniform(
        -0.5, 0.5, np.asarray(params["table"]).shape).astype(np.float32)
    params = {"table": jnp.asarray(table), "layers": params["layers"]}
    jdtrain.save_params(params, os.path.join(save_dir, "train_feat",
                                             "ckpt.npz"))

    cal = config["Dataset"]["Calibration"]
    qposes = np.loadtxt(os.path.join(config["Dataset"]["dataset_path"],
                                     "Sequence_2", "traj_w_c.txt"))
    rng = np.random.default_rng(3)
    lm = means[:n_lm]
    qf_dir = os.path.join(config["Dataset"]["generated_folder"], "scene",
                          "query_features")
    for i, c2w in enumerate(qposes.reshape(-1, 4, 4)):
        cam = JCamera.create(np.linalg.inv(c2w).astype(np.float32),
                             cal["fx"], cal["fy"], cal["cx"], cal["cy"], W, H)
        uv, z = (np.asarray(x) for x in cam.project(jnp.asarray(lm)))
        ok = ((z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < W)
              & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        desc = np.asarray(jdecoder.decode(params, jnp.asarray(lm[ok]), fcfg))
        desc = desc + rng.normal(0, 0.02, desc.shape)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        np.savez(os.path.join(qf_dir, f"rgb_{i}.npz"),
                 keypoints=uv[ok].astype(np.float32),
                 descriptors=desc.T.astype(np.float32))
    return config, save_dir


def _report_shape(text):
    return re.sub(r"-?\d+(\.\d+)?(e-?\d+)?", "#", text)


def test_eval_pose_matches_jax(session_dir):
    """EvalSession.eval_pose in both packages on the same files: the same
    query population and solved count, every per-query pose within 2 mm
    and 0.1 deg (the port draws its own RANSAC samples, so the winning
    hypotheses differ; the final Gauss-Newton on the strict inliers meets
    the same optimum), the same report format, and per-stage timings."""
    config, save_dir = session_dir
    out = {}
    for name, mod, kw in (("jax", jcli, {}), ("port", tcli,
                                              {"device": "cpu"})):
        session = mod.EvalSession(config, save_dir, **kw)
        seen = []
        extra = {}
        if name == "port":
            extra["on_query"] = lambda n, loc, r, m, f: seen.append(
                dict(loc.last_stages))
        m_t, m_r = session.eval_pose(save_pose=True, **extra)
        with open(os.path.join(save_dir, "eval_pose.txt")) as f:
            report = f.read()
        poses = {k: np.load(os.path.join(save_dir, "save_pose", f"{k}.npy"))
                 for k in ("match_r", "match_t", "retrieval_t", "gt")}
        out[name] = (m_t, m_r, report, poses, seen)
    jm_t, _, jrep, jp, _ = out["jax"]
    tm_t, _, trep, tp, seen = out["port"]
    assert len(tm_t) == len(jm_t) == 3
    solved = re.search(r"Solved: (\d+)\. Failed[^:]*: (\d+)", jrep)
    assert solved and int(solved.group(1)) >= 2, jrep
    assert solved.group(0) in trep
    assert _report_shape(trep) == _report_shape(jrep)
    np.testing.assert_array_equal(tp["retrieval_t"], jp["retrieval_t"])
    np.testing.assert_array_equal(tp["gt"], jp["gt"])
    for q in range(3):
        a = np.eye(4)
        b = np.eye(4)
        a[:3, :3], a[:3, 3] = tp["match_r"][q], tp["match_t"][q]
        b[:3, :3], b[:3, 3] = jp["match_r"][q], jp["match_t"][q]
        d, ang = _pose_err(np.linalg.inv(a), np.linalg.inv(b))
        assert d < 2e-3 and ang < 0.1, (q, d, ang)
    assert np.median(tm_t) < 0.1
    for st in seen:
        assert {"retrieval", "frustum", "decode", "match", "pnp",
                "total"} <= set(st), st
        assert st["total"] >= st["pnp"] > 0
