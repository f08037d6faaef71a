"""Port parity: raster.pairs against the JAX package. Identical depth-sorted
rect inputs (numpy from the JAX projection) go to both build_pairs; every
integer output must be bit-identical. Mirrors the pair tests of
tests/test_pallas.py on the port."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import binning as jbinning
from splatloc_tpu.raster import pairs as jpairs
from splatloc_tpu.raster import project as jproject
from splatloc_tpu.raster.types import RasterConfig as JConfig
from splatloc_tpu_torch.core.camera import Camera as TCamera
from splatloc_tpu_torch.raster import pairs as tpairs
from splatloc_tpu_torch.raster import rasterize as trasterize
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig

torch.set_num_threads(1)

W, H = 64, 48
KEYS = ("pair_idx", "starts", "counts", "per_rank_counts", "n_dropped",
        "n_trunc")


def make_scene(rng, n=300, giant=False, grow=1.0):
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    scales = grow * np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(
        np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    if giant:
        # one huge foreground splat covering most of the screen, and a few
        # mid-sized ones
        means[0] = [0.0, 0.0, 1.0]
        scales[0] = [1.2, 1.2, 0.01]
        opac[0] = 0.35
        scales[1:6] = 0.25
    return means, scales, quats, opac, colors


def _cam(w=W, h=H):
    return JCamera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, w / 2,
                          h / 2, w, h)


def sorted_rects(scene, cfg_kw, w=W, h=H):
    """Depth-sorted (xy, radius_xy, visible) as numpy, from the JAX
    projection."""
    means, scales, quats, opac, _ = scene
    proj = jproject.project_gaussians(
        *map(jnp.asarray, (means, scales, quats)), _cam(w, h),
        JConfig(**cfg_kw), opacities=jnp.asarray(opac))
    order = jbinning.depth_sort(proj)
    return tuple(np.array(x) for x in (proj.xy[order],
                                       proj.radius_xy[order],
                                       proj.visible[order]))


def _both(fn_j, fn_t, rects, w, h, cfg_kw):
    xy, rxy, vis = rects
    out_j = fn_j(jnp.asarray(xy), jnp.asarray(rxy), jnp.asarray(vis), w, h,
                 JConfig(**cfg_kw))
    out_t = fn_t(*map(torch.from_numpy, (xy, rxy, vis)), w, h,
                 TConfig(**cfg_kw))
    return out_j, out_t


CASES = {
    "default": dict(scene={}, cfg={}),
    "giant_big_tier": dict(scene=dict(giant=True),
                           cfg=dict(max_tiles=4, big_k=8)),
    "giant_both_tiers": dict(scene=dict(giant=True),
                             cfg=dict(max_tiles=4, big_k=2, big_tiles=10,
                                      mid_k=16, mid_tiles=6)),
    "truncated": dict(scene=dict(giant=True), cfg=dict(max_tiles=4,
                                                       big_k=0)),
    "pair_cap_drops": dict(scene=dict(grow=8.0),
                           cfg=dict(pair_cap_override=128)),
    "wide_image": dict(scene=dict(n=500), cfg=dict(max_tiles=6), w=160,
                       h=120),
}


@pytest.mark.parametrize("case", list(CASES))
def test_build_pairs_bit_identical(rng, case):
    spec = CASES[case]
    w, h = spec.get("w", W), spec.get("h", H)
    rects = sorted_rects(make_scene(rng, **spec["scene"]), spec["cfg"], w, h)
    pj, pt = _both(jpairs.build_pairs, tpairs.build_pairs, rects, w, h,
                   spec["cfg"])
    for k in KEYS:
        a, b = np.asarray(pj[k]), pt[k].numpy()
        assert b.dtype == np.int32, (k, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)
    n_cap = tpairs.aligned_cap(TConfig(**spec["cfg"]), len(rects[0]), w, h)
    assert n_cap == jpairs.aligned_cap(JConfig(**spec["cfg"]),
                                       len(rects[0]), w, h)
    assert pt["pair_idx"].shape == (n_cap,)
    if case == "truncated":
        assert int(pt["n_trunc"]) > 0
    if case == "pair_cap_drops":
        assert int(pt["n_dropped"]) > int(pt["n_trunc"])


@pytest.mark.parametrize("case", list(CASES))
def test_pair_stats_and_need_bit_identical(rng, case):
    spec = CASES[case]
    w, h = spec.get("w", W), spec.get("h", H)
    rects = sorted_rects(make_scene(rng, **spec["scene"]), spec["cfg"], w, h)
    sj, st = _both(jpairs.pair_stats, tpairs.pair_stats, rects, w, h,
                   spec["cfg"])
    assert [int(x) for x in st] == [int(x) for x in sj]
    nj, nt = _both(jpairs.pair_need, tpairs.pair_need, rects, w, h,
                   spec["cfg"])
    assert nt.dtype == torch.int32 and int(nt) == int(nj)
    # the stats agree with the sort-based builder
    pt = tpairs.build_pairs(*map(torch.from_numpy, rects), w, h,
                            TConfig(**spec["cfg"]))
    assert int(st[0]) == int(pt["counts"].sum())
    assert int(st[1]) == int(pt["n_dropped"])
    assert int(st[2]) == int(pt["n_trunc"])


@pytest.mark.parametrize("cfg_kw", [{}, dict(big_k=3, max_tiles=2),
                                    dict(big_tiles=None),
                                    dict(mid_tiles=8, max_tiles=4)])
@pytest.mark.parametrize("wh", [(64, 48), (640, 480), (1200, 680)])
def test_static_sizes_match(cfg_kw, wh):
    w, h = wh
    jc, tc = JConfig(**cfg_kw), TConfig(**cfg_kw)
    for n in (1, 300, 100_000):
        assert tpairs.extension_tiers(tc, n, w, h) == \
            jpairs.extension_tiers(jc, n, w, h)
        assert tpairs.resolve_caps(tc, n) == jpairs.resolve_caps(jc, n)
        assert tpairs.aligned_cap(tc, n, w, h) == \
            jpairs.aligned_cap(jc, n, w, h)
    assert tpairs.big_tiles_for(tc, w, h) == jpairs.big_tiles_for(jc, w, h)
    for cap in (1024 * 443, 1024 * 443 + 128):
        assert tpairs._misaligned(cap) == jpairs._misaligned(cap)


def test_bisect_is_lower_bound():
    """Left-side lower bound. The JAX bisection may return n + 1 for a
    query above every element (an extra round past lo == n); build_pairs
    only asks for queries <= the sentinel id, where both agree."""
    s = torch.tensor([0, 0, 2, 2, 2, 5, 9], dtype=torch.int32)
    q = torch.arange(11, dtype=torch.int32)
    ref = np.searchsorted(s.numpy(), q.numpy(), side="left")
    np.testing.assert_array_equal(tpairs._bisect(s, q).numpy(), ref)
    jref = np.asarray(jpairs._bisect(jnp.asarray(s.numpy()),
                                     jnp.asarray(q.numpy()), 4))
    np.testing.assert_array_equal(tpairs._bisect(s, q).numpy()[:10],
                                  jref[:10])


# ---- mirrors of tests/test_pallas.py ------------------------------------

def test_build_pairs_counts(rng):
    """Pair segments cover exactly the per-tile overlap sets of the JAX
    package's XLA binning (tile_lists), in the same depth order."""
    scene = make_scene(rng, 100)
    means, scales, quats, _, _ = scene
    cfg = JConfig(tile_size=16, max_per_tile=512, tile_chunk=4)
    proj = jproject.project_gaussians(*map(jnp.asarray, (means, scales,
                                                         quats)), _cam(),
                                      cfg)
    order = jbinning.depth_sort(proj)
    lists, counts_x, _ = jbinning.tile_lists(proj, order, W, H, cfg)
    pr = tpairs.build_pairs(
        torch.from_numpy(np.array(proj.xy[order])),
        torch.from_numpy(np.array(proj.radius_xy[order])),
        torch.from_numpy(np.array(proj.visible[order])), W, H,
        TConfig(tile_size=16, max_per_tile=512, tile_chunk=4))
    np.testing.assert_array_equal(pr["counts"].numpy(), np.asarray(counts_x))
    assert int(pr["n_dropped"]) == 0
    pi, st, ct = (pr[k].numpy() for k in ("pair_idx", "starts", "counts"))
    assert np.all(st % tpairs.ALIGN == 0)
    lx = np.asarray(lists)
    for t in range(len(ct)):
        np.testing.assert_array_equal(pi[st[t]:st[t] + ct[t]],
                                      lx[t][:ct[t]])


def test_giant_splat_extension(rng):
    """A splat whose tile rect far exceeds max_tiles drops no pairs: the
    top-K extension emits its remaining tiles."""
    rects = sorted_rects(make_scene(rng, 64, giant=True), {})
    cfg = TConfig(max_tiles=4, big_k=8)
    xy, rxy, vis = map(torch.from_numpy, rects)
    pr = tpairs.build_pairs(xy, rxy, vis, W, H, cfg)
    rminx, rmaxx, rminy, rmaxy = tpairs._tile_rects(xy, rxy, W, H, 16)
    assert int(((rmaxx - rminx) * (rmaxy - rminy)).max()) > 4
    assert int(pr["n_dropped"]) == 0
    assert int(pr["n_trunc"]) == 0
    kept, nd, nt = tpairs.pair_stats(xy, rxy, vis, W, H, cfg)
    assert int(nd) == 0 and int(nt) == 0
    assert int(kept) == int(pr["counts"].sum())


def _render(scene, cfg):
    means, scales, quats, opac, colors = map(torch.from_numpy, scene)
    cam = TCamera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                         H / 2, W, H, device="cpu")
    return trasterize(means, scales, quats, opac, colors, cam, cfg)


def test_pair_cap_override_zero_slack(rng):
    """pair_need measures the exact aligned pair-array need; with
    override = need - T*ALIGN the pair array has zero slack and the render
    is bit-identical to the default budget."""
    scene = make_scene(rng, 400)
    cfg = TConfig(tile_size=16, use_pallas=True)
    xy, rxy, vis = map(torch.from_numpy, sorted_rects(scene, {}))
    need = int(tpairs.pair_need(xy, rxy, vis, W, H, cfg))
    T = (-(-W // 16)) * (-(-H // 16))
    cfg2 = cfg.replace(pair_cap_override=max(need - T * tpairs.ALIGN, 128))
    assert tpairs.aligned_cap(cfg2, 400, W, H) <= need + 640
    assert tpairs.aligned_cap(cfg2, 400, W, H) < \
        tpairs.aligned_cap(cfg, 400, W, H)
    out0, out1 = _render(scene, cfg), _render(scene, cfg2)
    assert int(out1.n_dropped) == 0
    np.testing.assert_array_equal(out0.image.numpy(), out1.image.numpy())
    np.testing.assert_array_equal(out0.depth.numpy(), out1.depth.numpy())


def test_tile_rect_includes_boundary_pixel():
    """The exclusive-max tile index is floor((u+r)/ts)+1: a pixel at x=32
    with u+rx=32.9 lives in tile 2 and must be binned."""
    xy = torch.tensor([[30.57, 24.0]])
    rxy = torch.tensor([[2.35, 2.0]])
    rminx, rmaxx, rminy, rmaxy = tpairs._tile_rects(xy, rxy, W, H, 16)
    assert int(rmaxx[0]) == 3
    assert int(rminx[0]) == 1
    j = jpairs._tile_rects(jnp.asarray(xy.numpy()), jnp.asarray(rxy.numpy()),
                           W, H, 16)
    for a, b in zip(j, (rminx, rmaxx, rminy, rmaxy)):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
