"""Port parity for the mapping trainer's modules (train.losses, scene.optim,
the scene's slot management, knn, scene.init_rgbd, scene.densify,
train.mapping, train.checkpoint) against the JAX package on the same numpy
inputs. Random draws the two packages cannot share (JAX PRNG streams) are
taken from the JAX side and injected into the port. The JAX steps run the
Pallas path in interpret mode, as the JAX package's own tests run it."""
import dataclasses
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.knn import knn as jknn
from splatloc_tpu.scene import densify as jdensify
from splatloc_tpu.scene import init_rgbd as jinit
from splatloc_tpu.scene import optim as joptim
from splatloc_tpu.scene.gaussians import GaussianScene as JScene
from splatloc_tpu.train import checkpoint as jcheckpoint
from splatloc_tpu.train import losses as jlosses
from splatloc_tpu.train import mapping as jmapping
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.cli.config import load_config
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.knn import knn as tknn
from splatloc_tpu_torch.scene import densify as tdensify
from splatloc_tpu_torch.scene import init_rgbd as tinit
from splatloc_tpu_torch.scene import optim as toptim
from splatloc_tpu_torch.scene.gaussians import GaussianScene as TScene
from splatloc_tpu_torch.train import checkpoint as tcheckpoint
from splatloc_tpu_torch.train import losses as tlosses
from splatloc_tpu_torch.train import mapping as tmapping

torch.set_num_threads(1)

FIELDS = JScene.PARAM_FIELDS


def _t(x, **kw):
    return torch.from_numpy(np.array(x)).requires_grad_(kw.get("grad",
                                                               False))


def _np(x):
    return np.array(x.detach() if isinstance(x, torch.Tensor) else x)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _loss_inputs(seed=0, H=20, W=24):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    gt[0] = 0.0                                   # masked rgb pixels
    depth = rng.uniform(0.5, 4, (H, W)).astype(np.float32)
    gt_depth = rng.uniform(0.5, 4, (H, W)).astype(np.float32)
    gt_depth[1] = 0.0                             # masked depth pixels
    logits = rng.normal(size=(H, W)).astype(np.float32)
    score = (rng.uniform(size=(H, W)) > 0.8).astype(np.float32) * 0.5
    return img, gt, depth, gt_depth, logits, score


LOSS_CASES = {
    "mapping": (lambda m, i, g, d, gd, lg, s: m.mapping_loss(
        i, d, g, gd, 0.1, -0.05, 0.01), (0, 2)),
    "marker": (lambda m, i, g, d, gd, lg, s: m.marker_loss(lg, s), (4,)),
    "ssim": (lambda m, i, g, d, gd, lg, s: m.ssim(i, g), (0,)),
    "refinement": (lambda m, i, g, d, gd, lg, s: m.refinement_loss(
        i, g, 0.2), (0,)),
}


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_losses_match_jax(case):
    """Each loss's value within atol 1e-6 and its gradients (w.r.t. the
    rendered image, depth or logits) within rtol 1e-4 of the JAX
    package's."""
    fn, argnums = LOSS_CASES[case]
    ins = _loss_inputs()
    j_ins = [jnp.asarray(x) for x in ins]
    val_j, grads_j = jax.value_and_grad(
        lambda *a: fn(jlosses, *a), argnums=argnums)(*j_ins)
    t_ins = [_t(x, grad=i in argnums) for i, x in enumerate(ins)]
    val_t = fn(tlosses, *t_ins)
    grads_t = torch.autograd.grad(val_t, [t_ins[i] for i in argnums])
    np.testing.assert_allclose(float(val_t), float(val_j), atol=1e-6,
                               rtol=1e-6)
    for a, b in zip(grads_t, grads_j):
        scale = float(np.abs(_np(b)).max())
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4,
                                   atol=1e-6 * max(scale, 1e-3))


def test_isotropic_loss_matches_jax():
    rng = np.random.default_rng(1)
    n = 64
    scaling = rng.uniform(0.005, 0.05, (n, 3)).astype(np.float32)
    marker = np.where(rng.uniform(size=n) > 0.5, rng.uniform(0, 1, n),
                      0.0).astype(np.float32)
    alive = rng.uniform(size=n) > 0.2
    val_j, g_j = jax.value_and_grad(jlosses.isotropic_loss)(
        jnp.asarray(scaling), jnp.asarray(marker), jnp.asarray(alive))
    s_t = _t(scaling, grad=True)
    val_t = tlosses.isotropic_loss(s_t, _t(marker), _t(alive))
    (g_t,) = torch.autograd.grad(val_t, [s_t])
    np.testing.assert_allclose(float(val_t), float(val_j), atol=1e-6)
    np.testing.assert_allclose(_np(g_t), _np(g_j), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# optimiser
# --------------------------------------------------------------------------

def _param_dict(rng, n=40):
    return {"xyz": rng.normal(size=(n, 3)).astype(np.float32),
            "opacity": rng.normal(size=(n, 1)).astype(np.float32),
            "f_rest": np.zeros((n, 0, 3), np.float32)}


def test_adam_update_matches_jax():
    """Three Adam steps (eps 1e-15, per-group lrs with the scheduled xyz
    rate) from zero state: parameters and moments within rtol 1e-6."""
    rng = np.random.default_rng(2)
    p = _param_dict(rng)
    grads = [_param_dict(rng) for _ in range(3)]
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: _t(v) for k, v in p.items()}
    sj, st = joptim.init(pj), toptim.init(pt)
    for step, g in enumerate(grads, start=1):
        lrs_j = {"xyz": joptim.xyz_lr(step, 1e-3, 1e-5, max_steps=100),
                 "opacity": 0.05, "f_rest": 0.001}
        lrs_t = {"xyz": toptim.xyz_lr(step, 1e-3, 1e-5, max_steps=100),
                 "opacity": 0.05, "f_rest": 0.001}
        pj, sj = joptim.update(pj, {k: jnp.asarray(v) for k, v in g.items()},
                               sj, lrs_j)
        pt, st = toptim.update(pt, {k: _t(v) for k, v in g.items()}, st,
                               lrs_t)
    assert int(st.step) == int(sj.step) == 3
    for k in p:
        np.testing.assert_allclose(_np(pt[k]), _np(pj[k]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(_np(st.m[k]), _np(sj.m[k]), rtol=1e-6)
        np.testing.assert_allclose(_np(st.v[k]), _np(sj.v[k]), rtol=1e-6)


def test_lr_schedule_and_groups_match_jax():
    opt = dataclasses.asdict(tmapping.MappingConfig())
    opt = {k: opt[k] for k in tmapping.MappingConfig().opt_lr_dict()}
    for step in (0, 1, 7, 450, 29999, 40000):
        for delay in (0, 100):
            a = toptim.xyz_lr(step, 1e-3, 1e-6, delay, 0.01, 30000)
            b = joptim.xyz_lr(step, 1e-3, 1e-6, delay, 0.01, 30000)
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)
        lt = toptim.make_lrs(opt, 6.0, step)
        lj = joptim.make_lrs(opt, 6.0, step)
        assert set(lt) == set(lj)
        for k in lt:
            np.testing.assert_allclose(float(lt[k]), float(lj[k]),
                                       rtol=1e-6)


def test_zero_slots_and_field_match_jax():
    rng = np.random.default_rng(3)
    p = _param_dict(rng)
    m = _param_dict(rng)
    sj = joptim.AdamState(step=jnp.asarray(4, jnp.int32),
                          m={k: jnp.asarray(v) for k, v in m.items()},
                          v={k: jnp.asarray(v) ** 2 for k, v in m.items()})
    st = convert.adam_from_numpy(4, m, {k: v ** 2 for k, v in m.items()},
                                 "cpu")
    idx = np.array([3, 40, 7, 39, 1000], np.int32)   # 40+: dropped
    a = toptim.zero_slots(st, _t(idx))
    b = joptim.zero_slots(sj, jnp.asarray(idx))
    c = toptim.zero_field(st, "opacity")
    d = joptim.zero_field(sj, "opacity")
    for k in p:
        for x, y in ((a.m[k], b.m[k]), (a.v[k], b.v[k]), (c.m[k], d.m[k]),
                     (c.v[k], d.v[k])):
            np.testing.assert_array_equal(_np(x), _np(y))


# --------------------------------------------------------------------------
# slot management
# --------------------------------------------------------------------------

def _insert_values(B):
    ar = np.arange(B, dtype=np.float32)
    return {"xyz": np.tile(ar[:, None], (1, 3)),
            "f_dc": np.ones((B, 1, 3), np.float32),
            "f_rest": np.zeros((B, 0, 3), np.float32),
            "scaling": np.zeros((B, 3), np.float32),
            "rotation": np.tile(np.array([[1.0, 0, 0, 0]], np.float32),
                                (B, 1)),
            "opacity": np.zeros((B, 1), np.float32),
            "marker": ar[:, None] / B, "kp_score": np.zeros((B, 1),
                                                            np.float32)}


def _scenes(capacity, alive):
    js = JScene.empty(capacity).replace(alive=jnp.asarray(alive))
    ts = TScene.empty(capacity, device="cpu").replace(alive=_t(alive))
    return js, ts


@pytest.mark.parametrize("case", ["sparse", "budget_exceeds_capacity"])
def test_slots_and_insert_match_jax(case):
    """free_slots, slots_for and insert bit-identical to the JAX package's,
    including test_insert_budget_exceeds_capacity_compacts_valid's case
    (budget 64 > capacity 16, ten valid entries all land)."""
    rng = np.random.default_rng(4)
    if case == "sparse":
        cap, B = 50, 20
        alive = rng.uniform(size=cap) > 0.6
        valid = rng.uniform(size=B) > 0.3
    else:
        cap, B = 16, 64
        alive = np.zeros(cap, bool)
        valid = np.zeros(B, bool)
        valid[[1, 5, 20, 30, 40, 45, 50, 55, 60, 63]] = True
    js, ts = _scenes(cap, alive)
    for budget in (7, B):
        np.testing.assert_array_equal(_np(ts.free_slots(budget)),
                                      _np(js.free_slots(budget)))
    for x, y in zip(ts.slots_for(_t(valid)), js.slots_for(
            jnp.asarray(valid))):
        np.testing.assert_array_equal(_np(x), _np(y))
    vals = _insert_values(B)
    out_t = ts.insert({k: _t(v) for k, v in vals.items()}, _t(valid))
    out_j = js.insert({k: jnp.asarray(v) for k, v in vals.items()},
                      jnp.asarray(valid))
    for k in FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(out_t, k)),
                                      _np(getattr(out_j, k)), err_msg=k)
    if case != "sparse":
        assert int(out_t.num_alive) == 10
        got = sorted(_np(out_t.xyz[out_t.alive, 0]).tolist())
        assert got == [1, 5, 20, 30, 40, 45, 50, 55, 60, 63]


# --------------------------------------------------------------------------
# knn
# --------------------------------------------------------------------------

def _cloud(seed, n=700):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    return pts, valid


def test_morton_codes_bit_identical():
    pts, valid = _cloud(5)
    a = _np(tknn.morton_codes(_t(pts), _t(valid)))
    b = _np(jknn.morton_codes(jnp.asarray(pts), jnp.asarray(valid)))
    np.testing.assert_array_equal(a, b.astype(np.int64))
    assert a.max() > 2 ** 29                  # the high bits are exercised


@pytest.mark.parametrize("which", ["exact", "approx"])
def test_knn_matches_jax(which):
    pts, valid = _cloud(6)
    if which == "exact":
        a = tknn.knn_exact(_t(pts), _t(valid), block=256)
        b = jknn.knn_exact(jnp.asarray(pts), jnp.asarray(valid), block=256)
    else:
        a = tknn.mean_dist2_3nn_approx(_t(pts), _t(valid))
        b = jknn.mean_dist2_3nn_approx(jnp.asarray(pts), jnp.asarray(valid))
    np.testing.assert_allclose(_np(a), _np(b), atol=1e-6, rtol=0)
    assert (_np(a)[valid] > 0).all() and (_np(a)[~valid] == 0).all()


# --------------------------------------------------------------------------
# keyframe initialisation
# --------------------------------------------------------------------------

W0, H0 = 40, 30


def _rgbd(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (H0, W0, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4, (H0, W0)).astype(np.float32)
    depth[rng.uniform(size=(H0, W0)) < 0.1] = 0.0
    score = np.zeros((H0, W0), np.float32)
    score[::5, ::5] = rng.uniform(0, 1, score[::5, ::5].shape)
    w2c = np.asarray(jnp.eye(4)).astype(np.float32)
    w2c[:3, 3] = [0.1, -0.05, 0.2]
    return rgb, depth, score, w2c


def _init_kw():
    return dict(kp_budget=32, nonkp_budget=256, downsample=2,
                point_size=0.05, adaptive_pointsize=True)


def _cams(w2c, w=W0, h=H0):
    args = (w2c, 30.0, 30.0, w / 2, h / 2, w, h)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def test_frame_to_gaussians_matches_jax():
    """With the JAX draws injected: identical pixel indices and valid
    masks, values within atol 1e-6."""
    rgb, depth, score, w2c = _rgbd(7)
    jc, tc = _cams(w2c)
    key = jax.random.PRNGKey(3)
    vals_j, valid_j = jinit.frame_to_gaussians(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(score), jc, key,
        0.1, 0.02, **_init_kw())
    pri = jax.random.uniform(key, (H0 * W0,))
    vals_t, valid_t = tinit.frame_to_gaussians(
        _t(rgb), _t(depth), _t(score), tc, None, 0.1, 0.02,
        priorities=_t(pri), **_init_kw())
    np.testing.assert_array_equal(_np(valid_t), _np(valid_j))
    v = _np(valid_j)
    assert 32 < v.sum() <= 32 + 256
    for k in FIELDS:
        a, b = _np(vals_t[k]), _np(vals_j[k])
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a[v], b[v], atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def test_add_frame_matches_jax():
    rgb, depth, score, w2c = _rgbd(8)
    jc, tc = _cams(w2c)
    key = jax.random.PRNGKey(4)
    js = JScene.empty(600)
    ts = TScene.empty(600, device="cpu")
    js_, jo, nj = jinit.add_frame(js, joptim.init(js.params()),
                                  jnp.asarray(rgb), jnp.asarray(depth),
                                  jnp.asarray(score), jc, key, **_init_kw())
    ts_, to, nt = tinit.add_frame(
        ts, toptim.init(ts.params()), _t(rgb), _t(depth), _t(score), tc,
        priorities=_t(jax.random.uniform(key, (H0 * W0,))), **_init_kw())
    assert int(nt) == int(nj) > 0
    np.testing.assert_array_equal(_np(ts_.alive), _np(js_.alive))
    for k in FIELDS:
        np.testing.assert_allclose(_np(getattr(ts_, k)),
                                   _np(getattr(js_, k)), atol=1e-6,
                                   rtol=1e-6, err_msg=k)


def test_median_is_jnp_median():
    rng = np.random.default_rng(9)
    for n in (10, 11, 1200):
        x = rng.uniform(size=n).astype(np.float32)
        assert float(tinit._median(_t(x))) == float(jnp.median(x))


# --------------------------------------------------------------------------
# densification
# --------------------------------------------------------------------------

def _densify_state(seed, cap=300, n=200):
    rng = np.random.default_rng(seed)
    alive = np.zeros(cap, bool)
    alive[rng.permutation(cap)[:n]] = True
    fields = {
        "xyz": rng.normal(size=(cap, 3)).astype(np.float32),
        "f_dc": rng.normal(size=(cap, 1, 3)).astype(np.float32),
        "f_rest": np.zeros((cap, 0, 3), np.float32),
        "scaling": rng.uniform(-5, -1, (cap, 3)).astype(np.float32),
        "rotation": rng.normal(size=(cap, 4)).astype(np.float32),
        "opacity": rng.normal(size=(cap, 1)).astype(np.float32),
        "marker": np.where(rng.uniform(size=(cap, 1)) > 0.7, 0.5,
                           0.0).astype(np.float32),
        "kp_score": rng.normal(size=(cap, 1)).astype(np.float32),
        "alive": alive}
    grad = rng.uniform(0, 2e-4, (cap, 2)).astype(np.float32)
    radii = np.where(rng.uniform(size=cap) > 0.2,
                     rng.integers(1, 30, cap), 0).astype(np.int32)
    return fields, grad, radii


def test_add_stats_matches_jax():
    _, grad, radii = _densify_state(10)
    st = tdensify.DensifyStats.zeros(300, "cpu")
    sj = jdensify.DensifyStats.zeros(300)
    for _ in range(2):
        st = tdensify.add_stats(st, _t(grad), _t(radii), 64, 48)
        sj = jdensify.add_stats(sj, jnp.asarray(grad), jnp.asarray(radii),
                                64, 48)
    for k in ("xyz_gradient_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(_np(getattr(st, k)), _np(getattr(sj, k)),
                                   rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("primitive_reg", [True, False])
def test_densify_and_prune_matches_jax(primitive_reg):
    """Clone, split (the JAX normals injected) and prune: alive masks
    identical, parameters within atol 1e-6, Adam rows zeroed alike."""
    fields, grad, radii = _densify_state(11)
    js = convert.scene_from_numpy(fields, 0, "cpu")
    jscene = JScene(**{k: jnp.asarray(v) for k, v in fields.items()})
    rng = np.random.default_rng(12)
    m = {k: rng.normal(size=v.shape).astype(np.float32)
         for k, v in fields.items() if k != "alive"}
    so_t = convert.adam_from_numpy(5, m, m, "cpu")
    so_j = joptim.AdamState(step=jnp.asarray(5, jnp.int32),
                            m={k: jnp.asarray(v) for k, v in m.items()},
                            v={k: jnp.asarray(v) for k, v in m.items()})
    st = tdensify.add_stats(tdensify.DensifyStats.zeros(300, "cpu"),
                            _t(grad), _t(radii), 64, 48)
    sj = jdensify.add_stats(jdensify.DensifyStats.zeros(300),
                            jnp.asarray(grad), jnp.asarray(radii), 64, 48)
    kw = dict(max_grad=0.0002, min_opacity=0.3, extent=6.0,
              max_screen_size=20.0, percent_dense=0.01,
              primitive_reg=primitive_reg, clone_budget=32, split_budget=32)
    key = jax.random.PRNGKey(7)
    out_j = jax.jit(jdensify.densify_and_prune, static_argnames=tuple(kw))(
        jscene, sj, so_j, key, **kw)
    normals = _t(jax.random.normal(key, (2, 32, 3)))
    out_t = tdensify.densify_and_prune(js, st, so_t, None,
                                       split_normals=normals, **kw)
    (tsc, tst, tso, tinfo), (jsc, jst, jso, jinfo) = out_t, out_j
    for k in ("n_cloned", "n_split", "n_pruned"):
        assert int(tinfo[k]) == int(jinfo[k]), k
    assert int(tinfo["n_cloned"]) > 0 and int(tinfo["n_split"]) > 0
    np.testing.assert_array_equal(_np(tsc.alive), _np(jsc.alive))
    for k in FIELDS:
        np.testing.assert_allclose(_np(getattr(tsc, k)),
                                   _np(getattr(jsc, k)), atol=1e-6,
                                   rtol=1e-6, err_msg=k)
        np.testing.assert_array_equal(_np(tso.m[k]), _np(jso.m[k]))
    assert float(tst.denom.abs().sum()) == 0.0


def test_reset_opacity_nonvisible_matches_jax():
    fields, _, _ = _densify_state(13)
    ts = convert.scene_from_numpy(fields, 0, "cpu")
    js = JScene(**{k: jnp.asarray(v) for k, v in fields.items()})
    vis = np.random.default_rng(14).uniform(size=300) > 0.5
    m = {k: np.ones_like(v, np.float32) for k, v in fields.items()
         if k != "alive"}
    a, ao = tdensify.reset_opacity_nonvisible(
        ts, convert.adam_from_numpy(1, m, m, "cpu"), _t(vis))
    b, bo = jdensify.reset_opacity_nonvisible(
        js, joptim.AdamState(step=jnp.asarray(1),
                             m={k: jnp.asarray(v) for k, v in m.items()},
                             v={k: jnp.asarray(v) for k, v in m.items()}),
        jnp.asarray(vis))
    np.testing.assert_array_equal(_np(a.opacity), _np(b.opacity))
    np.testing.assert_array_equal(_np(ao.m["opacity"]), 0.0)
    np.testing.assert_array_equal(_np(ao.m["xyz"]), _np(bo.m["xyz"]))


# --------------------------------------------------------------------------
# the trainer: steps, determinism, checkpoints, cap escalation
# --------------------------------------------------------------------------

def _synthetic_frames(rng, cfg, n_frames=3):
    """RGB-D frames of a fixed random particle scene from slightly
    different poses (tests/test_train.py's generator)."""
    n_pts = 120
    pts = np.stack([
        rng.uniform(-1.2, 1.2, n_pts), rng.uniform(-0.9, 0.9, n_pts),
        rng.uniform(2.0, 4.0, n_pts)], -1).astype(np.float32)
    cols = rng.uniform(0.2, 1.0, (n_pts, 3)).astype(np.float32)
    frames = []
    for i in range(n_frames):
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        cam = JCamera.create(w2c, cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                             cfg.width, cfg.height)
        uv, z = cam.project(jnp.asarray(pts))
        uv = np.asarray(uv).round().astype(int)
        z = np.asarray(z)
        rgb = np.full((cfg.height, cfg.width, 3), 0.3, np.float32)
        dep = np.full((cfg.height, cfg.width), 3.0, np.float32)
        for j in np.argsort(-z):
            u, v = uv[j]
            if 1 <= u < cfg.width - 1 and 1 <= v < cfg.height - 1:
                rgb[v - 1:v + 2, u - 1:u + 2] = cols[j]
                dep[v - 1:v + 2, u - 1:u + 2] = z[j]
        score = np.zeros((cfg.height, cfg.width), np.float32)
        score[::7, ::7] = 0.5
        frames.append((rgb, dep, score, w2c))
    return frames


# the pair path on the CPU (its kernels' plain versions) in both packages:
# use_pallas=None would pick the tiled blend there
SMALL = dict(width=32, height=24, fx=25.0, fy=25.0, cx=16.0, cy=12.0,
             window_size=2, tile_chunk=2, max_per_tile=128, kp_budget=32,
             nonkp_budget=256, pcd_downsample=2, gaussian_reset=10 ** 9,
             gaussian_update_every=10 ** 9, use_pallas=True)
LADDER = dict(width=48, height=36, fx=40.0, fy=40.0, cx=24.0, cy=18.0,
              window_size=2, tile_chunk=3, max_per_tile=256, kp_budget=64,
              nonkp_budget=512, pcd_downsample=2, use_pallas=True)


def _jax_state(jt) -> dict:
    """A JAX trainer's state as numpy, in trainer_state_from_numpy's
    arguments."""
    fs = jt.frames
    return dict(
        scene={k: np.asarray(getattr(jt.scene, k))
               for k in FIELDS + ("alive",)},
        adam={"step": np.asarray(jt.opt_state.step),
              "m": {k: np.asarray(v) for k, v in jt.opt_state.m.items()},
              "v": {k: np.asarray(v) for k, v in jt.opt_state.v.items()}},
        stats={k: np.asarray(getattr(jt.stats, k)) for k in (
            "xyz_gradient_accum", "denom", "max_radii2d")},
        frames={"n": fs.n, **{k: np.asarray(getattr(fs, k)[:fs.n]) for k in (
            "rgb", "depth_mm", "score", "w2c", "exposure")}},
        iteration=jt.iteration)


@pytest.fixture(scope="module")
def small_pair():
    """A JAX trainer (Pallas path, interpret mode) with two keyframes and a
    port trainer carrying the same state."""
    jcfg = jmapping.MappingConfig(**SMALL)
    jt = jmapping.MappingTrainer(jcfg, capacity=1024, frame_capacity=4,
                                 seed=3)
    for f in _synthetic_frames(np.random.default_rng(5), jcfg, 2):
        jt.add_keyframe(*f)
    pt = tmapping.MappingTrainer(tmapping.MappingConfig(**SMALL),
                                 capacity=1024, frame_capacity=4, seed=3,
                                 device="cpu")
    convert.trainer_state_from_numpy(pt, **_jax_state(jt))
    return jt, pt


def test_mapping_step_matches_jax(small_pair):
    """One mapping step from the same state and zero Adam moments: the loss
    within rel 1e-5, the gradients (m = 0.1 g after one step) within 1e-3
    relative L2, densify stats, visibility and drop counters alike."""
    jt, pt = small_pair
    assert pt.cfg.visible_cap == jt.cfg.visible_cap
    idx = [0, 1]
    js = jt._mapping_step(jt.scene, joptim.init(jt.scene.params()),
                          jdensify.DensifyStats.zeros(jt.scene.capacity),
                          jt.frames.gather(jnp.asarray(idx)),
                          jnp.asarray(1))
    ts = pt._mapping_step(pt.scene, toptim.init(pt.scene.params()),
                          tdensify.DensifyStats.zeros(pt.scene.capacity,
                                                      "cpu"),
                          pt.frames.gather(idx), 1)
    (j_scene, j_opt, j_stats, j_loss, j_vis, j_nd) = js
    (t_scene, t_opt, t_stats, t_loss, t_vis, t_nd) = ts
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for k in FIELDS:
        a, b = _np(t_opt.m[k]), _np(j_opt.m[k])
        assert a.shape == b.shape, k
        if b.size and np.abs(b).max() > 0:
            assert _rel_l2(a, b) <= 1e-3, (k, _rel_l2(a, b))
        else:
            np.testing.assert_array_equal(a, 0.0, err_msg=k)
    assert np.abs(_np(t_opt.m["xyz"])).max() > 0
    np.testing.assert_array_equal(_np(t_vis), _np(j_vis))
    np.testing.assert_array_equal(_np(t_nd), _np(j_nd))
    np.testing.assert_array_equal(_np(t_stats.denom), _np(j_stats.denom))
    np.testing.assert_array_equal(_np(t_stats.max_radii2d),
                                  _np(j_stats.max_radii2d))
    assert _rel_l2(_np(t_stats.xyz_gradient_accum),
                   _np(j_stats.xyz_gradient_accum)) <= 1e-3


def test_refinement_step_matches_jax(small_pair):
    jt, pt = small_pair
    fj = jax.tree.map(lambda x: x[0], jt.frames.gather(jnp.asarray([1])))
    ft = {k: x[0] for k, x in pt.frames.gather([1]).items()}
    _, j_opt, j_loss, j_nd = jt._refine_step(
        jt.scene, joptim.init(jt.scene.params()), fj, jnp.asarray(1))
    _, t_opt, t_loss, t_nd = pt._refine_step(
        pt.scene, toptim.init(pt.scene.params()), ft, 1)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    for k in ("xyz", "f_dc", "opacity", "scaling", "rotation"):
        assert _rel_l2(_np(t_opt.m[k]), _np(j_opt.m[k])) <= 1e-3, k
    np.testing.assert_array_equal(_np(t_nd), _np(j_nd))


def test_jax_checkpoint_loads_into_port(small_pair, tmp_path):
    """A checkpoint the JAX package wrote loads into a port trainer with
    every field equal (the JAX PRNG key is not taken)."""
    jt, _ = small_pair
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(jt, path)
    pt = tmapping.MappingTrainer(tmapping.MappingConfig(**SMALL),
                                 capacity=1024, frame_capacity=4, seed=99,
                                 device="cpu")
    tcheckpoint.load(pt, path)
    for k in FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(pt.scene, k)),
                                      np.asarray(getattr(jt.scene, k)), k)
    for k in FIELDS:
        np.testing.assert_array_equal(_np(pt.opt_state.m[k]),
                                      np.asarray(jt.opt_state.m[k]))
        np.testing.assert_array_equal(_np(pt.opt_state.v[k]),
                                      np.asarray(jt.opt_state.v[k]))
    assert int(pt.opt_state.step) == int(jt.opt_state.step)
    assert pt.frames.n == jt.frames.n and pt.iteration == jt.iteration
    for k in ("rgb", "depth_mm", "score", "w2c", "exposure"):
        np.testing.assert_array_equal(
            _np(getattr(pt.frames, k)[:pt.frames.n]).astype(np.float64),
            np.asarray(getattr(jt.frames, k)[:jt.frames.n]).astype(
                np.float64), k)
    # the numpy host RNG continues the JAX trainer's window sampling
    assert (pt.host_rng.permutation(2).tolist()
            == jt.host_rng.permutation(2).tolist())


def _port_trainer(cfg_kw, seed, frames_seed, n_frames, capacity=1024):
    cfg = tmapping.MappingConfig(**cfg_kw)
    t = tmapping.MappingTrainer(cfg, capacity=capacity, frame_capacity=8,
                                seed=seed, device="cpu")
    for f in _synthetic_frames(np.random.default_rng(frames_seed), cfg,
                               n_frames):
        t.add_keyframe(*f)
    return t


def test_trainer_determinism():
    """Mirror of test_mapping_determinism: two port trainers with the same
    seed give bit-identical scenes."""
    def run():
        t = _port_trainer(SMALL, 11, 9, 2)
        t.map(iters=4)
        return t

    t1, t2 = run(), run()
    for k in FIELDS + ("alive",):
        np.testing.assert_array_equal(_np(getattr(t1.scene, k)),
                                      _np(getattr(t2.scene, k)), k)
    assert int(t1.scene.num_alive) > 50


def test_checkpoint_resume(tmp_path):
    """Mirror of test_checkpoint_resume: save, continue; load into a fresh
    trainer, continue alike: the same trajectory."""
    t1 = _port_trainer(SMALL, 3, 5, 2)
    t1.map(iters=2)
    path = str(tmp_path / "ckpt.npz")
    tcheckpoint.save(t1, path)
    t1.map(iters=2)
    t2 = tmapping.MappingTrainer(tmapping.MappingConfig(**SMALL),
                                 capacity=1024, frame_capacity=8, seed=3,
                                 device="cpu")
    tcheckpoint.load(t2, path)
    t2.map(iters=2)
    np.testing.assert_array_equal(_np(t2.scene.xyz), _np(t1.scene.xyz))
    np.testing.assert_array_equal(_np(t2.scene.opacity),
                                  _np(t1.scene.opacity))
    assert t2.iteration == t1.iteration


@pytest.fixture(scope="module")
def ladder_pair():
    """JAX and port trainers on test_train.py's 48x36 configuration, with
    the same three keyframes; the port carries the JAX trainer's state."""
    jcfg = jmapping.MappingConfig(max_per_tile=4096,
                                  **{k: v for k, v in LADDER.items()
                                     if k != "max_per_tile"})
    jt = jmapping.MappingTrainer(jcfg, capacity=4096, frame_capacity=8)
    caps = []
    for f in _synthetic_frames(np.random.default_rng(0), jcfg):
        jt.add_keyframe(*f)
        caps.append((int(jt.scene.num_alive), jt.cfg.visible_cap))
    return jt, caps


def test_visible_cap_tiering(ladder_pair):
    """Mirror of test_visible_cap_tiering: the port keeps visible_cap at
    the same tier as the JAX trainer at every keyframe (the alive counts
    agree: the random draws pick which pixels, not how many), holds it
    through a densify, and no step reports visible Gaussians dropped."""
    _, caps = ladder_pair
    cfg_kw = dict(LADDER, gaussian_update_every=10, gaussian_update_offset=5,
                  gaussian_th=0.3, gaussian_reset=10 ** 9)
    cfg = tmapping.MappingConfig(**cfg_kw)
    t = tmapping.MappingTrainer(cfg, capacity=4096, frame_capacity=8,
                                device="cpu")
    assert t.cfg.visible_cap is not None
    for f, (alive_j, cap_j) in zip(_synthetic_frames(
            np.random.default_rng(0), cfg), caps):
        t.add_keyframe(*f)
        assert (int(t.scene.num_alive), t.cfg.visible_cap) == (alive_j,
                                                               cap_j)
    t.map(iters=7)                               # through one densify
    k = t.cfg.visible_cap
    assert k is None or k >= int(t.scene.num_alive)
    for arr in t._pending_dropped:
        assert int(arr[2]) == 0
    step_fn = t._mapping_step
    t._refresh_visible_cap()
    assert t.cfg.visible_cap == k and t._mapping_step is step_fn


def _port_from(jt, cfg_kw):
    t = tmapping.MappingTrainer(tmapping.MappingConfig(**cfg_kw),
                                capacity=4096, frame_capacity=8,
                                device="cpu")
    convert.trainer_state_from_numpy(t, **_jax_state(jt))
    t.cfg = dataclasses.replace(t.cfg, visible_cap=jt.cfg.visible_cap)
    t._rebuild_steps()
    return t


def test_tighten_pair_cap_probe(ladder_pair):
    """Mirror of test_tighten_pair_cap_probe on the JAX trainer's scene:
    the same override integer as the JAX trainer; a no-op second call; a
    forced tiny override surfaces drops in refinement and is cleared."""
    jt0, _ = ladder_pair
    cfg_kw = dict(LADDER, pair_cap_factor=12)
    t = _port_from(jt0, cfg_kw)
    jt = jmapping.MappingTrainer(jmapping.MappingConfig(**cfg_kw),
                                 capacity=4096, frame_capacity=8)
    jt.scene, jt.frames = jt0.scene, jt0.frames
    jt.cfg = dataclasses.replace(jt.cfg, visible_cap=jt0.cfg.visible_cap)
    assert t.tighten_pair_cap() and jt.tighten_pair_cap()
    assert t.cfg.pair_cap_override == jt.cfg.pair_cap_override is not None
    assert not t.tighten_pair_cap()
    t.cfg = dataclasses.replace(t.cfg, pair_cap_override=128)
    t._rebuild_steps()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t.color_refinement(total_iters=2, probe_caps=False)
    assert any("dropped" in str(x.message) for x in w)
    assert t.cfg.pair_cap_override is None
    assert t.n_dropped_total > 0


def test_growth_ladder_pair_cap(ladder_pair):
    """Mirror of test_growth_ladder_pair_cap: past the min-interval guard
    the ladder sets the same override as the JAX trainer; the tightened
    step drops nothing; an immediate re-probe is a no-op."""
    jt0, _ = ladder_pair
    cfg_kw = dict(LADDER, max_per_tile=4096)
    t = _port_from(jt0, cfg_kw)
    jt = jmapping.MappingTrainer(jmapping.MappingConfig(**cfg_kw),
                                 capacity=4096, frame_capacity=8)
    jt.scene, jt.frames = jt0.scene, jt0.frames
    jt.cfg = dataclasses.replace(jt.cfg, visible_cap=jt0.cfg.visible_cap)
    t.iteration = jt.iteration = 1000
    t._ladder_pair_cap()
    jt._ladder_pair_cap()
    assert t.cfg.pair_cap_override == jt.cfg.pair_cap_override is not None
    t.map(2)
    t._check_pair_truncation()
    assert t.n_dropped_total == 0
    override = t.cfg.pair_cap_override
    t._ladder_pair_cap()
    assert t.cfg.pair_cap_override == override


def test_mapping_config_from_replica_yaml():
    """MappingConfig.from_config(load_config(...)) on the shipped Replica
    config matches the JAX package's."""
    from splatloc_tpu.cli.config import load_config as jload
    path = str(Path(__file__).resolve().parent.parent / "configs" / "replica"
               / "base_config.yaml")
    a = tmapping.MappingConfig.from_config(load_config(path))
    b = jmapping.MappingConfig.from_config(jload(path))
    fa = dataclasses.asdict(a)
    fb = dataclasses.asdict(b)
    assert fa == fb
    assert (a.width, a.height, a.window_size, a.gaussian_update_every,
            a.gaussian_update_offset) == (640, 480, 5, 150, 50)
    assert a.raster_config().use_pallas
