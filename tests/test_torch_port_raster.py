"""Port parity: the pair-walk forward (raster.hopper_raster) and the
rasterize entry point against the JAX package's Pallas path, run in
interpret mode on the CPU as its own tests run it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import transforms as jtf
from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import binning as jbinning
from splatloc_tpu.raster import pallas_raster as jpr
from splatloc_tpu.raster import project as jproject
from splatloc_tpu.raster import rasterize as jrasterize
from splatloc_tpu.raster.types import RasterConfig as JConfig
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.raster import hopper_raster as tpr
from splatloc_tpu_torch.raster import pairs as tpairs
from splatloc_tpu_torch.raster import rasterize as trasterize
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig

torch.set_num_threads(1)

W, H = 64, 48
CFG = dict(tile_size=16, use_pallas=True)


def make_scene(rng, n=300, channels=4, dense=False, giant=False):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    lo, hi = (-3.0, -1.8) if dense else (-4.5, -2.5)
    scales = np.exp(rng.uniform(lo, hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.6 if dense else 0.2, 0.97, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, channels)).astype(np.float32)
    if giant:
        means[0] = [0.0, 0.0, 1.0]
        scales[0] = [1.2, 1.2, 0.01]
        opac[0] = 0.35
    return means, scales, quats, opac, colors


def _pose(rng, scale=0.05):
    xi = rng.normal(scale=scale, size=(6,)).astype(np.float32)
    return np.asarray(jtf.se3_exp(jnp.asarray(xi)))


def _cams(w2c=None):
    if w2c is None:
        w2c = np.eye(4, dtype=np.float32)
    args = (w2c, 50.0, 50.0, W / 2, H / 2, W, H)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_forward(means, scales, quats, opac, colors, cam, cfg):
    """JAX _forward_impl in interpret mode on the JAX projection; returns
    the kernel inputs and its raw [T, C+4, P] output."""
    proj = jproject.project_gaussians(means, scales, quats, cam, cfg,
                                      opacities=opac)
    order = jbinning.depth_sort(proj)
    out, pr, gpair = jpr._forward_impl(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c), opac,
        proj.depth, colors, (proj.radius_x, proj.radius_y), proj.visible,
        order.astype(jnp.int32), cam.width, cam.height, cfg, True)
    screen = dict(u=proj.u, v=proj.v, ca=proj.conic_a, cb=proj.conic_b,
                  cc=proj.conic_c, depth=proj.depth, rx=proj.radius_x,
                  ry=proj.radius_y, visible=proj.visible, order=order)
    return out, pr, gpair, screen


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_rasterize(means, scales, quats, opac, colors, cam, bg, cfg,
                   alive=None, offset=None):
    return jrasterize(means, scales, quats, opac, colors, cam, cfg, bg=bg,
                      alive=alive, means2d_offset=offset)


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


FWD_CASES = {
    "default": (dict(), dict()),
    "dense_saturating": (dict(dense=True), dict()),
    "giant_extension": (dict(giant=True), dict(max_tiles=4, big_k=8)),
    "eight_channels": (dict(channels=8), dict()),
    "visible_cap": (dict(), dict(visible_cap=128)),
}


def _assert_acc_close(acc_t, acc_j, C):
    np.testing.assert_allclose(acc_t[:, :C], acc_j[:, :C], atol=5e-5,
                               rtol=0, err_msg="channels")
    np.testing.assert_allclose(acc_t[:, C + 1], acc_j[:, C + 1], atol=5e-5,
                               rtol=0, err_msg="weight sum")
    np.testing.assert_allclose(acc_t[:, C], acc_j[:, C], atol=2e-4, rtol=0,
                               err_msg="depth")
    np.testing.assert_array_equal(acc_t[:, C + 2], acc_j[:, C + 2],
                                  err_msg="n_contrib")
    np.testing.assert_allclose(acc_t[:, C + 3], acc_j[:, C + 3], atol=1e-6,
                               rtol=0, err_msg="t_final")


@pytest.mark.parametrize("case", list(FWD_CASES))
def test_plain_walk_matches_jax_kernel(rng, case):
    """fwd_pairwalk_plain on the JAX gpair/starts/counts equals the raw
    [T, C+4, P] of the JAX kernel (_forward_impl, interpret mode)."""
    scene_kw, cfg_kw = FWD_CASES[case]
    means, scales, quats, opac, colors = make_scene(rng, **scene_kw)
    jc, _ = _cams()
    cfg = dict(CFG, **cfg_kw)
    out_j, pr_j, gpair_j, _ = _jax_forward(
        *map(jnp.asarray, (means, scales, quats, opac, colors)), jc,
        JConfig(**cfg))
    _, origins = tpr._origins(W, H, 16)
    C = colors.shape[1]
    acc_t = tpr.fwd_pairwalk_plain(
        _t(gpair_j), _t(pr_j["starts"]), _t(pr_j["counts"]),
        torch.from_numpy(origins), C, TConfig(**cfg)).numpy()
    acc_j = _np(out_j)
    assert acc_t.shape == acc_j.shape == (12, C + 4, 256)
    _assert_acc_close(acc_t, acc_j, C)
    if case == "dense_saturating":
        # the early-exit path is exercised: some pixels saturate
        assert (acc_j[:, C + 3] < 1e-3).any()
    assert (acc_j[:, C + 2] >= 0).any()


@pytest.mark.parametrize("case", ["default", "giant_extension",
                                  "visible_cap"])
def test_pair_inputs_match_jax(rng, case):
    """Given the JAX projection, the port's table build, pair build and
    pack gather produce bit-identical kernel inputs."""
    scene_kw, cfg_kw = FWD_CASES[case]
    means, scales, quats, opac, colors = make_scene(rng, **scene_kw)
    jc, _ = _cams()
    cfg = dict(CFG, **cfg_kw)
    _, pr_j, gpair_j, s = _jax_forward(
        *map(jnp.asarray, (means, scales, quats, opac, colors)), jc,
        JConfig(**cfg))
    gpair_t, pr_t, origins = tpr._pair_inputs(
        (_t(s["u"]), _t(s["v"])), (_t(s["ca"]), _t(s["cb"]), _t(s["cc"])),
        _t(opac), _t(s["depth"]), _t(colors), (_t(s["rx"]), _t(s["ry"])),
        _t(s["visible"]), _t(s["order"]), W, H, TConfig(**cfg))
    np.testing.assert_array_equal(gpair_t.numpy(), _np(gpair_j))
    for k in ("pair_idx", "starts", "counts", "per_rank_counts",
              "n_dropped", "n_trunc", "n_vis_dropped"):
        np.testing.assert_array_equal(pr_t[k].numpy(), _np(pr_j[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(origins.numpy(), tpr._origins(W, H, 16)[1])


def test_build_per_g_sentinel_column(rng):
    """The table takes the sentinel-free depth order: column j is Gaussian
    order[j] and column K is all zeros, the inert entry that pair index K
    selects. It equals the JAX table built from order + [n]."""
    n, K, C = 50, 40, 4
    cols = [rng.normal(size=n).astype(np.float32) for _ in range(7)]
    colors = rng.uniform(size=(n, C)).astype(np.float32)
    rxy = [rng.uniform(1, 3, n).astype(np.float32) for _ in range(2)]
    vis = (rng.uniform(size=n) > 0.2).astype(np.float32)
    order = rng.permutation(n)[:K].astype(np.int32)

    tab_t = tpr._build_per_g(
        (_t(cols[0]), _t(cols[1])), tuple(_t(c) for c in cols[2:5]),
        _t(cols[5]), _t(cols[6]), _t(colors), torch.from_numpy(order).long(),
        radius_xy=tuple(_t(r) for r in rxy), visible_f=_t(vis)).numpy()
    order_p = np.concatenate([order, [n]]).astype(np.int32)
    tab_j = _np(jpr._build_per_g(
        (jnp.asarray(cols[0]), jnp.asarray(cols[1])),
        tuple(jnp.asarray(c) for c in cols[2:5]), jnp.asarray(cols[5]),
        jnp.asarray(cols[6]), jnp.asarray(colors), jnp.asarray(order_p),
        radius_xy=tuple(jnp.asarray(r) for r in rxy),
        visible_f=jnp.asarray(vis)))
    assert tab_t.shape == (tpr._rows_for(C), K + 1)
    np.testing.assert_array_equal(tab_t, tab_j)
    np.testing.assert_array_equal(tab_t[:, K], 0.0)
    np.testing.assert_array_equal(tab_t[tpr.R_X, :K], cols[0][order])
    rrx, rry, rvis = tpr._rect_rows(C)
    np.testing.assert_array_equal(tab_t[rvis, :K], vis[order])
    # the pack gather clamps every pair index past K onto the sentinel
    idx = torch.tensor([0, K - 1, K, K + 7], dtype=torch.int32)
    g = tpr._gather_pairs(torch.from_numpy(tab_t),
                          torch.clamp(idx, max=K)).numpy()
    np.testing.assert_array_equal(g[:, 2:], 0.0)
    np.testing.assert_array_equal(g[:, 0], tab_t[:, 0])


RASTER_CASES = {
    "bg": dict(bg=True),
    "posed_camera": dict(pose=True, bg=True),
    "means2d_offset": dict(offset=True),
    "alive_mask": dict(alive=True),
}


@pytest.mark.parametrize("case", list(RASTER_CASES))
def test_rasterize_matches_jax(rng, case):
    """End to end, with test_pallas_forward_parity's tolerances."""
    spec = RASTER_CASES[case]
    sc = make_scene(rng)
    n = len(sc[0])
    jc, tc = _cams(_pose(rng) if spec.get("pose") else None)
    bg = (np.array([0.1, 0.2, 0.3, 0.0], np.float32) if spec.get("bg")
          else np.zeros(4, np.float32))
    alive = (np.arange(n) % 4 != 0) if spec.get("alive") else None
    off = (rng.normal(scale=0.7, size=(n, 2)).astype(np.float32)
           if spec.get("offset") else None)
    out_j = _jax_rasterize(*map(jnp.asarray, sc), jc, jnp.asarray(bg),
                           JConfig(**CFG),
                           None if alive is None else jnp.asarray(alive),
                           None if off is None else jnp.asarray(off))
    out_t = trasterize(*map(_t, sc), tc, TConfig(**CFG), bg=_t(bg),
                       alive=None if alive is None else _t(alive),
                       means2d_offset=None if off is None else _t(off))
    np.testing.assert_allclose(out_t.image.numpy(), _np(out_j.image),
                               atol=5e-5, rtol=0)
    np.testing.assert_allclose(out_t.depth.numpy(), _np(out_j.depth),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(out_t.alpha.numpy(), _np(out_j.alpha),
                               atol=5e-5, rtol=0)
    np.testing.assert_array_equal(out_t.radii.numpy(), _np(out_j.radii))
    np.testing.assert_allclose(out_t.means2d.numpy(), _np(out_j.means2d),
                               atol=1e-4, rtol=0)
    for k in ("n_dropped", "n_trunc", "n_vis_dropped"):
        assert int(getattr(out_t, k)) == int(getattr(out_j, k)), k
    assert out_t.image.shape == (H, W, 4)
    assert float(out_t.alpha.max()) > 0.5


def test_visible_cap_exact_and_counted(rng):
    """visible_cap slices the depth-sorted active set: with K >= the
    visible count the render is bit-identical to uncapped, and with K below
    it the overflow is counted in n_vis_dropped (equal to the JAX count),
    and the capped render still matches the JAX one."""
    sc = make_scene(rng, 300)
    jc, tc = _cams()
    alive = np.arange(300) < 200
    bg = np.zeros(4, np.float32)

    def port(cfg_kw):
        return trasterize(*map(_t, sc), tc, TConfig(**CFG, **cfg_kw),
                          alive=_t(alive))

    out0 = port({})
    out1 = port(dict(visible_cap=256))
    assert int(out1.n_vis_dropped) == 0
    np.testing.assert_array_equal(out0.image.numpy(), out1.image.numpy())
    np.testing.assert_array_equal(out0.depth.numpy(), out1.depth.numpy())

    out2 = port(dict(visible_cap=128))
    ref2 = _jax_rasterize(*map(jnp.asarray, sc), jc, jnp.asarray(bg),
                          JConfig(**CFG, visible_cap=128),
                          jnp.asarray(alive), None)
    assert int(out2.n_vis_dropped) > 0
    assert int(out2.n_vis_dropped) == int(ref2.n_vis_dropped)
    assert int(out2.n_dropped) == int(ref2.n_dropped)
    assert bool(torch.isfinite(out2.image).all())
    np.testing.assert_allclose(out2.image.numpy(), _np(ref2.image),
                               atol=5e-5, rtol=0)


def test_render_output_drop_counters_match_pair_stats(rng):
    """rasterize's n_dropped/n_trunc come from the pair build inside
    blend_pairs and agree with pair_stats (and with the JAX package)."""
    means, scales, quats, opac, colors = make_scene(rng, 96, giant=True)
    jc, tc = _cams()
    cfg_kw = dict(CFG, max_tiles=4, big_k=0)        # force truncation
    out = trasterize(*map(_t, (means, scales, quats, opac, colors)), tc,
                     TConfig(**cfg_kw))
    from splatloc_tpu_torch.raster import project as tproject
    proj = tproject.project_gaussians(_t(means), _t(scales), _t(quats), tc,
                                      TConfig(**cfg_kw), opacities=_t(opac))
    _, nd, nt = tpairs.pair_stats(proj.xy, proj.radius_xy, proj.visible, W,
                                  H, TConfig(**cfg_kw))
    assert int(out.n_dropped) == int(nd)
    assert int(out.n_trunc) == int(nt) > 0
    ref = _jax_rasterize(*map(jnp.asarray, (means, scales, quats, opac,
                                            colors)), jc,
                         jnp.zeros(4), JConfig(**cfg_kw))
    assert int(out.n_dropped) == int(ref.n_dropped)
    assert int(out.n_trunc) == int(ref.n_trunc)


def test_blend_backward_raises(rng):
    """The blend's backward runs (it no longer raises): .backward()
    through rasterize gives finite, non-zero gradients on every input, and
    the drop counters are outputs without gradients."""
    sc = [_t(x) for x in make_scene(rng, 80)]
    for x in sc:
        x.requires_grad_(True)
    _, tc = _cams()
    out = trasterize(*sc, tc, TConfig(**CFG))
    assert out.image.requires_grad
    (out.image.sum() + out.depth.sum()).backward()
    for x in sc:
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert float(x.grad.abs().max()) > 0
    assert not out.n_dropped.requires_grad


def test_tiled_path_not_ported(rng):
    """The tiled path (use_pallas=False) is ported: it renders what the JAX
    package's tiled blend renders, to the render limits."""
    sc = make_scene(rng, 20)
    jc, tc = _cams()
    cfg = dict(tile_size=16, max_per_tile=256, tile_chunk=4)
    out = trasterize(*[_t(x) for x in sc], tc, TConfig(**cfg))
    ref = _jax_rasterize(*map(jnp.asarray, sc), jc, jnp.zeros((4,)),
                         JConfig(**cfg))
    np.testing.assert_allclose(out.image.numpy(), _np(ref.image), atol=5e-5)
    np.testing.assert_allclose(out.depth.numpy(), _np(ref.depth), atol=2e-4)
    np.testing.assert_allclose(out.alpha.numpy(), _np(ref.alpha), atol=5e-5)
    assert int(out.n_dropped) == int(ref.n_dropped)


def test_fwd_pairwalk_wrapper_cpu_and_checks(rng):
    """On CPU tensors the wrapper runs the plain version (no kernel launch
    counted); malformed inputs raise instead of launching."""
    sc = make_scene(rng, 120)
    jc, _ = _cams()
    out_j, pr_j, gpair_j, _ = _jax_forward(*map(jnp.asarray, sc), jc,
                                           JConfig(**CFG))
    _, origins = tpr._origins(W, H, 16)
    args = [_t(gpair_j), _t(pr_j["starts"]), _t(pr_j["counts"]),
            torch.from_numpy(origins)]
    before = tpr.fwd_pairwalk.launches
    got = tpr.fwd_pairwalk(*args, 4, TConfig(**CFG))
    assert tpr.fwd_pairwalk.launches == before
    np.testing.assert_array_equal(
        got.numpy(), tpr.fwd_pairwalk_plain(*args, 4, TConfig(**CFG)).numpy())
    bad = [
        [args[0].double()] + args[1:],
        [args[0], args[1].long()] + args[2:],
        args[:3] + [args[3][:-2]],
        [args[0][:5]] + args[1:],
    ]
    for b in bad:
        with pytest.raises(ValueError):
            tpr.fwd_pairwalk(*b, 4, TConfig(**CFG))
    with pytest.raises(ValueError):
        tpr.fwd_pairwalk(*args, 4, TConfig(**dict(CFG, tile_size=64)))
    with pytest.raises(ValueError, match="meta"):
        tpr.fwd_pairwalk(*(a.to("meta") for a in args), 4, TConfig(**CFG))


def test_assemble_image_matches_jax(rng):
    T, C, P = 12, 4, 256
    acc = rng.normal(size=(T, C + 4, P)).astype(np.float32)
    bg = rng.uniform(size=C).astype(np.float32)
    got = tpr.assemble_image(_t(acc), W - 5, H - 3, TConfig(), _t(bg))
    ref = jpr.assemble_image(jnp.asarray(acc), W - 5, H - 3, JConfig(),
                             jnp.asarray(bg))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), _np(b), atol=1e-6)
