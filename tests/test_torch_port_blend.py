"""Port parity for the tiled path (``use_pallas=False``): binning.tile_lists,
raster.blend, raster.reference and rasterize's blend branch against the
JAX package on the same numpy inputs, mirroring tests/test_raster.py at its
limits; and the raster path picked by device."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import binning as jbinning
from splatloc_tpu.raster import blend as jblend
from splatloc_tpu.raster import project as jproject
from splatloc_tpu.raster import rasterize as jrasterize
from splatloc_tpu.raster.reference import rasterize_reference as jreference
from splatloc_tpu.raster.types import RasterConfig as JConfig
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.raster import binning as tbinning
from splatloc_tpu_torch.raster import blend as tblend
from splatloc_tpu_torch.raster import hopper_raster
from splatloc_tpu_torch.raster import rasterize as trasterize
from splatloc_tpu_torch.raster import render as trender
from splatloc_tpu_torch.raster import render_features as trender_features
from splatloc_tpu_torch.raster.reference import \
    rasterize_reference as treference
from splatloc_tpu_torch.raster.types import Projected
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig
from splatloc_tpu_torch.scene.gaussians import GaussianScene as TScene

torch.set_num_threads(1)

N = 200
W, H = 64, 48
# tests/test_raster.py's configuration
CFG = dict(tile_size=16, max_per_tile=256, tile_chunk=4)


def make_scene(rng, n=N, c=4):
    """tests/test_raster.py's scene distribution, as numpy."""
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                      rng.uniform(1.0, 5.0, n)], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, c)).astype(np.float32)
    return means, scales, quats, opac, colors


def _cams(w=W, h=H):
    args = (np.eye(4, dtype=np.float32), 50.0, 50.0, w / 2, h / 2, w, h)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_rasterize(means, scales, quats, opac, colors, cam, cfg, alive,
                   bg):
    return jrasterize(means, scales, quats, opac, colors, cam, cfg, bg=bg,
                      alive=alive)


def _both(sc, cfg=CFG, alive=None, bg=None):
    jc, tc = _cams()
    n = sc[0].shape[0]
    alive = np.ones(n, bool) if alive is None else alive
    bg = np.zeros(sc[4].shape[-1], np.float32) if bg is None else bg
    j = _jax_rasterize(*map(jnp.asarray, sc), jc, JConfig(**cfg),
                       jnp.asarray(alive), jnp.asarray(bg))
    t = trasterize(*map(_t, sc), tc, TConfig(**cfg), bg=_t(bg),
                   alive=_t(alive))
    return j, t


def _jax_projection(sc, cfg):
    jc, _ = _cams()
    proj = jproject.project_gaussians(*map(jnp.asarray, sc[:3]), jc,
                                      JConfig(**cfg),
                                      opacities=jnp.asarray(sc[3]))
    return proj, jbinning.depth_sort(proj)


def _as_port(proj) -> Projected:
    return Projected(**{k: _t(getattr(proj, k)) for k in (
        "u", "v", "depth", "conic_a", "conic_b", "conic_c", "radius",
        "visible", "radius_x", "radius_y")})


@pytest.mark.parametrize("case", ["fits", "overflow", "chunk_1"])
def test_tile_lists_bit_identical(rng, case):
    """Given the JAX projection and order: the same lists, counts and
    n_dropped, bit for bit, with and without capacity overflow."""
    cfg = dict(CFG)
    if case == "overflow":
        cfg["max_per_tile"] = 8
    if case == "chunk_1":
        cfg["tile_chunk"] = 1
    sc = make_scene(rng, n=300)
    proj, order = _jax_projection(sc, cfg)
    lj, cj, dj = jbinning.tile_lists(proj, order, W, H, JConfig(**cfg))
    lt, ct, dt = tbinning.tile_lists(_as_port(proj), _t(order), W, H,
                                     TConfig(**cfg))
    assert lt.dtype == ct.dtype == dt.dtype == torch.int32
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert int(dt) == int(dj)
    assert (int(dt) > 0) == (case == "overflow")


def test_blend_image_matches_jax(rng):
    """blend_image on the same tile lists and sorted attributes, with a
    background: image, depth and alpha to tests/test_raster.py's limits."""
    sc = make_scene(rng)
    proj, order = _jax_projection(sc, CFG)
    lists, _, _ = jbinning.tile_lists(proj, order, W, H, JConfig(**CFG))
    args = (proj.xy[order], proj.conic[order], jnp.asarray(sc[3])[order],
            jnp.asarray(sc[4])[order], proj.depth[order])
    bg = np.array([0.2, 0.5, 0.1, 0.0], np.float32)
    ref = jblend.blend_image(lists, *args, W, H, JConfig(**CFG),
                             jnp.asarray(bg))
    got = tblend.blend_image(_t(lists), *map(_t, args), W, H,
                             TConfig(**CFG), _t(bg))
    for a, b, tol in zip(got, ref, (1e-5, 1e-4, 1e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_tiled_matches_jax_and_reference(seed):
    """rasterize(use_pallas=False) against the JAX tiled path (the render
    limits: 5e-5, depth 2e-4) and against the port's per-pixel oracle
    (tests/test_raster.py: 1e-5, depth 1e-4), radii equal; the oracle
    against the JAX oracle."""
    sc = make_scene(np.random.default_rng(seed))
    j, t = _both(sc)
    np.testing.assert_allclose(t.image.numpy(), np.asarray(j.image),
                               atol=5e-5)
    np.testing.assert_allclose(t.depth.numpy(), np.asarray(j.depth),
                               atol=2e-4)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha),
                               atol=5e-5)
    np.testing.assert_array_equal(t.radii.numpy(), np.asarray(j.radii))
    assert int(t.n_dropped) == int(j.n_dropped)
    assert int(t.n_trunc) == int(t.n_vis_dropped) == 0
    jc, tc = _cams()
    ref_t = treference(*map(_t, sc), tc, TConfig(**CFG))
    ref_j = jreference(*map(jnp.asarray, sc), jc, JConfig(**CFG))
    np.testing.assert_allclose(t.image.numpy(), ref_t[0].numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(t.depth.numpy(), ref_t[1].numpy(), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(t.alpha.numpy(), ref_t[2].numpy(), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(t.radii.numpy(), ref_t[3].numpy())
    for a, b, tol in zip(ref_t[:3], ref_j[:3], (5e-5, 2e-4, 5e-5)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    np.testing.assert_array_equal(ref_t[3].numpy(), np.asarray(ref_j[3]))


def test_reference_at_listed_pixels(rng):
    """rasterize_reference(pixels=...) gives the full oracle's values at
    those pixels (image, depth, alpha), in the listed order."""
    sc = make_scene(rng)
    _, tc = _cams()
    bg = _t(np.array([0.1, 0.2, 0.3, 0.0], np.float32))
    full = treference(*map(_t, sc), tc, TConfig(**CFG), bg=bg)
    pix = np.stack([rng.integers(0, W, 40), rng.integers(0, H, 40)], -1)
    at = treference(*map(_t, sc), tc, TConfig(**CFG), bg=bg,
                    pixels=torch.from_numpy(pix))
    assert tuple(at[0].shape) == (40, 4) and tuple(at[1].shape) == (40,)
    for a, f in zip(at[:3], full[:3]):
        np.testing.assert_allclose(a.numpy(), f[pix[:, 1], pix[:, 0]].numpy(),
                                   atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(at[3].numpy(), full[3].numpy())


def test_background_alive_and_depth_order(rng):
    """Mirrors of test_background_composite, test_alive_mask and
    test_depth_ordering on the port's tiled path."""
    sc = make_scene(rng, n=5)
    bg = np.array([1.0, 0.5, 0.25, 0.0], np.float32)
    _, t = _both(sc, bg=bg)
    empty = t.alpha.numpy() == 0.0
    assert empty.any()
    np.testing.assert_allclose(t.image.numpy()[empty],
                               np.broadcast_to(bg, (empty.sum(), 4)),
                               atol=1e-6)

    sc = make_scene(rng)
    alive = np.arange(N) < N // 2
    _, masked = _both(sc, alive=alive)
    _, subset = _both(tuple(x[:N // 2] for x in sc))
    np.testing.assert_allclose(masked.image.numpy(), subset.image.numpy(),
                               atol=1e-5)
    assert (masked.radii.numpy()[N // 2:] == 0).all()

    means = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 4.0]], np.float32)
    two = (means, np.full((2, 3), 0.05, np.float32),
           np.tile(np.array([1.0, 0, 0, 0], np.float32), (2, 1)),
           np.array([0.95, 0.95], np.float32),
           np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0]], np.float32))
    _, a = _both(two)
    _, b = _both(tuple(x[::-1].copy() for x in two))
    centre = a.image.numpy()[H // 2, W // 2]
    assert centre[0] > centre[1]              # red (near) dominates
    np.testing.assert_allclose(b.image.numpy(), a.image.numpy(), atol=1e-6)


def test_capacity_overflow_drops_farthest(rng):
    """Mirror of test_capacity_overflow_drops_farthest: with a per-tile
    capacity of 16 the nearest Gaussians win, and the image equals the
    uncut one (transmittance past 16 layers of opacity 0.6 is below the
    cutoff); the cut is counted in n_dropped."""
    n = 64
    means = np.zeros((n, 3), np.float32)
    means[:, 2] = np.linspace(2.0, 6.0, n)
    sc = (means, np.full((n, 3), 10.0, np.float32),
          np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
          np.full((n,), 0.6, np.float32),
          rng.uniform(0, 1, (n, 4)).astype(np.float32))
    _, full = _both(sc, dict(max_per_tile=64, tile_chunk=2))
    _, cut = _both(sc, dict(max_per_tile=16, tile_chunk=2))
    np.testing.assert_allclose(cut.image.numpy(), full.image.numpy(),
                               atol=1e-5)
    assert int(full.n_dropped) == 0 < int(cut.n_dropped)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_tiled_gradients_match_jax_and_reference(rng):
    """Gradients through the tiled blend (checkpointed per chunk of tiles)
    against the JAX tiled path's within 1e-3 relative L2 for every input,
    and against the port's per-pixel oracle (tests/test_raster.py's
    test_grad_parity_with_reference: atol 2e-5, rtol 2e-4)."""
    sc = make_scene(rng, n=60)
    jc, tc = _cams()
    target = np.random.default_rng(3).uniform(0, 1, (H, W, 4)).astype(
        np.float32)

    def jloss(*a):
        out = jrasterize(*a, jc, JConfig(**CFG))
        return (jnp.mean((out.image - target) ** 2)
                + 0.05 * jnp.mean(out.depth))
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, sc))

    def port_grads(fn):
        xs = [_t(x).requires_grad_(True) for x in sc]
        img, dep = fn(xs)
        loss = (torch.mean((img - _t(target)) ** 2)
                + 0.05 * torch.mean(dep))
        return torch.autograd.grad(loss, xs)

    def tiled(xs):
        out = trasterize(*xs, tc, TConfig(**CFG))
        return out.image, out.depth

    def oracle(xs):
        img, dep, _, _ = treference(*xs, tc, TConfig(**CFG))
        return img, dep
    gt, go = port_grads(tiled), port_grads(oracle)
    for i, (a, b, c) in enumerate(zip(gt, gj, go)):
        a, b, c = a.numpy(), np.asarray(b), c.numpy()
        assert np.isfinite(a).all() and np.abs(a).max() > 0, i
        assert _rel_l2(a, b) <= 1e-3, (i, _rel_l2(a, b))
        np.testing.assert_allclose(a, c, atol=2e-5, rtol=2e-4,
                                   err_msg=f"grad arg {i}")


def test_means2d_offset_grad_on_tiled_path(rng):
    """Mirror of test_means2d_offset_grad: the offset's gradient is nonzero
    for visible Gaussians and zero for culled ones."""
    sc = list(map(_t, make_scene(rng)))
    sc[0][:5, 2] = -3.0                      # behind the camera
    _, tc = _cams()
    off = torch.zeros((N, 2), requires_grad=True)
    out = trasterize(*sc, tc, TConfig(**CFG), means2d_offset=off)
    (g,) = torch.autograd.grad(torch.sum(out.image ** 2), off)
    radii = out.radii.numpy()
    assert (g.numpy()[radii == 0] == 0).all()
    assert (np.abs(g.numpy()[radii > 0]) > 0).any()


def _scene(sc):
    means, scales, quats, opac, colors = map(_t, sc)
    n = means.shape[0]
    return TScene(xyz=means, f_dc=((colors[:, None, :3] - 0.5)
                                   / 0.28209479177387814),
                  f_rest=torch.zeros((n, 0, 3)), scaling=torch.log(scales),
                  rotation=quats, opacity=torch.logit(opac)[:, None],
                  marker=torch.zeros((n, 1)), kp_score=colors[:, 3:],
                  alive=torch.ones((n,), dtype=torch.bool), sh_degree=0)


def test_render_and_render_features_default_config(rng):
    """render and render_features work with the default RasterConfig()
    (the tiled blend) and launch no pair kernel: render's RGB equals the
    tiled rasterize of the SH colours."""
    sc = make_scene(rng)
    scene = _scene(sc)
    _, tc = _cams()
    before = hopper_raster.fwd_pairwalk.launches
    out = trender(scene, tc)
    feats = trender_features(scene, tc, torch.ones((N, 6)))
    assert hopper_raster.fwd_pairwalk.launches == before
    assert out["render"].shape == (H, W, 3)
    assert feats["feature_map"].shape == (H, W, 6)
    np.testing.assert_allclose(feats["opacity"].numpy(),
                               out["opacity"].numpy(), atol=1e-6)
    # a channel of ones composites to the alpha
    np.testing.assert_allclose(feats["feature_map"][..., 0].numpy(),
                               out["opacity"].numpy(), atol=1e-5)


@pytest.mark.parametrize("device,pair", [("cpu", False), ("cuda", True),
                                         ("cuda:1", True)])
def test_raster_path_by_device(device, pair):
    """RasterConfig.for_device and MappingConfig.raster_config: None picks
    the pair kernels on a CUDA device and the tiled blend on the CPU; an
    explicit use_pallas is honoured on both."""
    from splatloc_tpu_torch.train.mapping import MappingConfig
    assert TConfig.for_device(device) == TConfig(use_pallas=pair)
    assert MappingConfig().raster_config(device).use_pallas is pair
    for explicit in (True, False):
        cfg = MappingConfig(use_pallas=explicit)
        assert cfg.raster_config(device).use_pallas is explicit
    assert MappingConfig().raster_config().use_pallas

