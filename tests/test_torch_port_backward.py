"""Port parity: the blend's backward (raster.hopper_raster) against the JAX
package's Pallas backward, run in interpret mode on the CPU as its own tests
run it: the per-pair gradient slab of the backward walk, the per-Gaussian
reduction, and the gradients of ``rasterize``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
T, P = 12, 256
CFG = dict(tile_size=16, use_pallas=True)


def make_scene(seed, n=300, dense=False, giant=False):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    lo, hi = (-3.0, -1.8) if dense else (-4.5, -2.5)
    scales = np.exp(rng.uniform(lo, hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.6 if dense else 0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    if giant:
        means[0] = [0.0, 0.0, 1.0]
        scales[0] = [1.2, 1.2, 0.01]
        opac[0] = 0.35
    return means, scales, quats, opac, colors


def _cams(w2c=None):
    w2c = np.eye(4, dtype=np.float32) if w2c is None else w2c
    args = (w2c, 50.0, 50.0, W / 2, H / 2, W, H)
    return JCamera.create(*args), TCamera.create(*args, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_forward(means, scales, quats, opac, colors, cam, cfg):
    proj = jproject.project_gaussians(means, scales, quats, cam, cfg,
                                      opacities=opac)
    order = jbinning.depth_sort(proj)
    out, pr, gpair = jpr._forward_impl(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c), opac,
        proj.depth, colors, (proj.radius_x, proj.radius_y), proj.visible,
        order.astype(jnp.int32), cam.width, cam.height, cfg, True)
    return out, pr, gpair


@functools.partial(jax.jit, static_argnames=("cfg", "slab"))
def _jax_bwd_slab(starts, counts, origins, gpair, out, cot, cfg, slab):
    jpr.GRAD_SLAB_DTYPE = slab
    rows = gpair.shape[0]
    return jpr._run_bwd_kernel(starts, counts, origins, gpair, out, cot, T,
                               P, 4, rows, cfg, True)[:, :rows]


SLAB_CASES = {
    "default": (dict(), dict()),
    "dense_saturating": (dict(dense=True), dict()),
    "giant_extension": (dict(giant=True), dict(max_tiles=4, big_k=8)),
    "pairs_dropped": (dict(dense=True), dict(pair_cap_override=128)),
}


@pytest.fixture(scope="module")
def slab_refs():
    """Per case: the JAX forward's kernel inputs, a seeded cotangent, and
    the JAX backward kernel's f32 and bf16 slabs (interpret mode)."""
    old = jpr.GRAD_SLAB_DTYPE
    refs = {}
    try:
        for i, (case, (scene_kw, cfg_kw)) in enumerate(SLAB_CASES.items()):
            sc = make_scene(10 + i, **scene_kw)
            jc, _ = _cams()
            cfg = JConfig(**CFG, **cfg_kw)
            out, pr, gpair = _jax_forward(*map(jnp.asarray, sc), jc, cfg)
            cot = jnp.asarray(np.random.default_rng(20 + i).normal(
                size=(T, 6, P)).astype(np.float32))
            origins = jnp.asarray(jpr._origins(W, H, 16)[1])
            slabs = {name: np.asarray(_jax_bwd_slab(
                pr["starts"], pr["counts"], origins, gpair, out, cot, cfg,
                dt).astype(jnp.float32))
                for name, dt in (("f32", jnp.float32),
                                 ("bf16", jnp.bfloat16))}
            refs[case] = dict(out=out, pr=pr, gpair=gpair, cot=cot,
                              origins=origins, slabs=slabs,
                              cfg=TConfig(**CFG, **cfg_kw))
    finally:
        jpr.GRAD_SLAB_DTYPE = old
    return refs


def _port_slab(ref, dtype):
    pr = ref["pr"]
    jhi = tpr._jhi(_t(ref["out"]), _t(pr["starts"]), _t(pr["counts"]), 4)
    slab = tpr.bwd_pairwalk_plain(
        _t(ref["gpair"]), _t(pr["starts"]), _t(pr["counts"]),
        _t(ref["origins"]), jhi, _t(ref["out"]), _t(ref["cot"]), 4,
        ref["cfg"], dtype)
    return slab, jhi


def _segment_mask(pr, pc):
    """Positions inside some tile's 128-aligned segment (the rows the
    walk writes)."""
    starts, counts = np.asarray(pr["starts"]), np.asarray(pr["counts"])
    mask = np.zeros(pc, bool)
    for s, c in zip(starts, counts):
        mask[s:s + -(-c // 128) * 128] = True
    return mask


# rows that pass through the six power coefficients (x, y, conic a, b, c):
# the chain back from the coefficients cancels terms up to ~1e3 times the
# result (|d0| * ex^2 against d_ca), so the order in which the pixel sums
# round shows there at ~1e-5 of the slab's scale; the other rows are sums
# of products and hold 1e-6
CHAIN_ROWS = (tpr.R_X, tpr.R_Y, tpr.R_CA, tpr.R_CB, tpr.R_CC)


def _row_atol(r, scale):
    return (1e-5 if r in CHAIN_ROWS else 1e-6) * scale


@pytest.mark.parametrize("case", list(SLAB_CASES))
def test_plain_bwd_slab_matches_jax_kernel(slab_refs, case):
    """bwd_pairwalk_plain's f32 slab against the JAX kernel's on the same
    gpair, forward output, cotangent and jhi. Every written row within
    rtol 1e-4 and atol 1e-6 * max(scale, 1), scale the slab's largest value
    (as test_pallas_gradient_parity scales by each gradient's); the rows
    through the power coefficients within atol 1e-5 * max(scale, 1) and
    relative L2 1e-5 (see CHAIN_ROWS). Rows past each tile's jhi are
    zeros."""
    ref = slab_refs[case]
    slab, jhi = _port_slab(ref, torch.float32)
    got = slab.numpy()
    want = ref["slabs"]["f32"]
    mask = _segment_mask(ref["pr"], got.shape[0])
    scale = max(float(np.abs(want[mask]).max()), 1.0)
    for r in range(got.shape[1]):
        a, b = got[mask, r], want[mask, r]
        np.testing.assert_allclose(a, b, atol=_row_atol(r, scale),
                                   rtol=1e-4, err_msg=f"{case} row {r}")
        assert np.linalg.norm(a - b) <= 1e-5 * max(np.linalg.norm(b),
                                                   1e-12), (case, r)
    starts = np.asarray(ref["pr"]["starts"])
    counts = np.asarray(ref["pr"]["counts"])
    for s, c, j in zip(starts, counts, jhi.numpy()):
        np.testing.assert_array_equal(got[s + (j + 1) * 128:
                                          s + -(-c // 128) * 128], 0.0)
    # a gradient was produced at all, and only in the gradient rows
    assert np.abs(got[mask, :tpr.N_FIXED + 4]).max() > 0
    np.testing.assert_array_equal(got[mask, tpr.N_FIXED + 4:], 0.0)
    if case == "pairs_dropped":
        assert int(ref["pr"]["n_dropped"]) > 0


def test_bf16_slab_matches_jax(slab_refs):
    """The bf16 slab rounds as astype(bf16) does: at least 99 % of the
    written values bit-equal to JAX's, the rest within one bf16 ulp of it
    beyond the f32 slab's own tolerance (test above)."""
    for case, ref in slab_refs.items():
        slab, _ = _port_slab(ref, torch.bfloat16)
        assert slab.dtype == torch.bfloat16
        got = slab.float().numpy()
        want = ref["slabs"]["bf16"]
        mask = _segment_mask(ref["pr"], got.shape[0])
        g, w = got[mask], want[mask]
        assert (g == w).mean() >= 0.99, (case, (g == w).mean())
        scale = max(float(np.abs(ref["slabs"]["f32"][mask]).max()), 1.0)
        for r in range(g.shape[1]):
            ulp = np.abs(w[:, r]) * 2.0 ** -7
            assert (np.abs(g[:, r] - w[:, r])
                    <= ulp + _row_atol(r, scale)).all(), (case, r)


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("case", ["default", "giant_extension",
                                  "pairs_dropped"])
def test_reduction_matches_jax(slab_refs, case, mode, monkeypatch):
    """The per-Gaussian reduction on the same f32 slab against JAX's
    _reduce_to_gauss under both SEGSCAN_MODEs (rtol 1e-5), including a
    case with dropped pairs (partial runs)."""
    monkeypatch.setattr(jpr, "SEGSCAN_MODE", mode)
    ref = slab_refs[case]
    pr = ref["pr"]
    slab = ref["slabs"]["f32"]
    K = int(np.asarray(pr["per_rank_counts"]).shape[0])
    kmax = tpairs.big_tiles_for(ref["cfg"], W, H)
    pad = np.zeros((slab.shape[0], 128), np.float32)
    pad[:, :slab.shape[1]] = slab
    want = np.asarray(jpr._reduce_to_gauss(
        jnp.asarray(pad), pr["pair_idx"], pr["per_rank_counts"], K, 4, kmax,
        True))
    got = tpr.seg_reduce(_t(slab), _t(pr["pair_idx"]),
                         _t(pr["per_rank_counts"]), kmax).numpy()
    assert got.shape == want.shape == (K, slab.shape[1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.abs(got).max() > 0


def test_reduction_ignores_unwritten_tail(slab_refs):
    """The slab past the last tile's segment is never written (torch.empty):
    NaN there reaches no rank below K, and the NaN-poisoned result equals
    the clean one."""
    ref = slab_refs["default"]
    pr = ref["pr"]
    slab, _ = _port_slab(ref, torch.float32)
    mask = torch.from_numpy(_segment_mask(pr, slab.shape[0]))
    assert bool((~mask).any())
    clean = slab.clone()
    clean[~mask] = 0.0
    slab[~mask] = float("nan")
    args = (_t(pr["pair_idx"]), _t(pr["per_rank_counts"]), 192)
    got = tpr.seg_reduce(slab, *args)
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, tpr.seg_reduce(clean, *args),
                               rtol=0, atol=0)


def test_wrappers_on_cpu_run_plain_and_check_inputs(slab_refs):
    """On CPU tensors the wrappers run their plain versions (no launch
    counted); malformed inputs raise instead of launching."""
    ref = slab_refs["default"]
    pr = ref["pr"]
    args = [_t(ref["gpair"]), _t(pr["starts"]), _t(pr["counts"]),
            _t(ref["origins"])]
    jhi = tpr._jhi(_t(ref["out"]), args[1], args[2], 4)
    rest = [jhi, _t(ref["out"]), _t(ref["cot"])]
    before = (tpr.bwd_pairwalk.launches, tpr.seg_reduce.launches)
    slab = tpr.bwd_pairwalk(*args, *rest, 4, ref["cfg"], torch.float32)
    plain, _ = _port_slab(ref, torch.float32)
    mask = torch.from_numpy(_segment_mask(pr, slab.shape[0]))
    torch.testing.assert_close(slab[mask], plain[mask], rtol=0, atol=0)
    pair_idx, prc = _t(pr["pair_idx"]), _t(pr["per_rank_counts"])
    red = tpr.seg_reduce(slab, pair_idx, prc, 192)
    assert red.shape == (prc.shape[0], slab.shape[1])
    # a larger kmax only adds scan passes that find no longer runs
    torch.testing.assert_close(
        tpr.seg_reduce(slab, pair_idx, prc, 8192), red, rtol=0, atol=0)
    assert (tpr.bwd_pairwalk.launches, tpr.seg_reduce.launches) == before
    with pytest.raises(ValueError):
        tpr.bwd_pairwalk(*args, jhi.long(), *rest[1:], 4, ref["cfg"])
    with pytest.raises(ValueError):
        tpr.bwd_pairwalk(*args, jhi, rest[1], rest[2][:, :5], 4,
                         ref["cfg"])
    with pytest.raises(ValueError):
        tpr.bwd_pairwalk(*args, *rest, 4, ref["cfg"], torch.float16)
    with pytest.raises(ValueError):
        tpr.seg_reduce(slab, pair_idx.long(), prc, 192)
    with pytest.raises(ValueError):
        tpr.seg_reduce(slab, pair_idx[:-1], prc, 192)
    with pytest.raises(ValueError):
        tpr.seg_reduce(slab.double(), pair_idx, prc, 192)
    with pytest.raises(ValueError, match="meta"):
        tpr.seg_reduce(slab.to("meta"), pair_idx.to("meta"),
                       prc.to("meta"), 192)


# --------------------------------------------------------------------------
# gradients through rasterize
# --------------------------------------------------------------------------

def _rel_l2(a, b):
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-12))


def _targets():
    return np.random.default_rng(1).uniform(0, 1, (H, W, 4)).astype(
        np.float32)


def _jax_grads(sc, w2c, cfg):
    jc, _ = _cams()
    target = jnp.asarray(_targets())

    def f(means, scales, quats, opac, colors, w2c_):
        o = jrasterize(means, scales, quats, opac, colors,
                       jc.replace_pose(w2c_), cfg, bg=jnp.zeros(4))
        return jnp.mean((o.image - target) ** 2) + 0.05 * jnp.mean(o.depth)

    g = jax.jit(jax.grad(f, argnums=tuple(range(6))))(
        *map(jnp.asarray, sc), jnp.asarray(w2c))
    return [np.asarray(x) for x in g]


def _port_grads(sc, w2c, cfg, slab_dtype, monkeypatch):
    monkeypatch.setattr(tpr, "GRAD_SLAB_DTYPE", slab_dtype)
    args = [_t(x).requires_grad_(True) for x in sc]
    w2c_t = _t(w2c).requires_grad_(True)
    _, tc = _cams()
    out = trasterize(*args, tc.replace_pose(w2c_t), cfg,
                     bg=torch.zeros(4))
    loss = (torch.mean((out.image - _t(_targets())) ** 2)
            + 0.05 * torch.mean(out.depth))
    grads = torch.autograd.grad(loss, args + [w2c_t])
    return [g.numpy() for g in grads]


@pytest.fixture(scope="module")
def grad_refs():
    """JAX gradients of test_pallas_gradient_parity's loss (f32 slab) for
    two scenes (the second with a visible_cap below the visible count)."""
    old = jpr.GRAD_SLAB_DTYPE
    jpr.GRAD_SLAB_DTYPE = jnp.float32
    try:
        sc = make_scene(0)
        w2c = np.eye(4, dtype=np.float32)
        capped = JConfig(**CFG, visible_cap=128)
        return {"uncapped": (sc, w2c, _jax_grads(sc, w2c, JConfig(**CFG))),
                "visible_cap": (sc, w2c, _jax_grads(sc, w2c, capped))}
    finally:
        jpr.GRAD_SLAB_DTYPE = old


GRAD_NAMES = ("means", "scales", "quats", "opacity", "colors", "w2c")


def test_rasterize_grads_match_jax(grad_refs, monkeypatch):
    """Mirror of test_pallas_gradient_parity: every gradient within 1e-3
    relative L2 of the JAX package's (both with f32 slabs)."""
    sc, w2c, want = grad_refs["uncapped"]
    got = _port_grads(sc, w2c, TConfig(**CFG), torch.float32, monkeypatch)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


def test_visible_cap_ranks_beyond_get_zero_grads(grad_refs, monkeypatch):
    """visible_cap K below the visible count: the Gaussians past the K
    nearest get exactly zero blend gradients, as in the JAX package, and
    the rest match it."""
    sc, w2c, want = grad_refs["visible_cap"]
    cfg = TConfig(**CFG, visible_cap=128)
    got = _port_grads(sc, w2c, cfg, torch.float32, monkeypatch)
    _, tc = _cams()
    from splatloc_tpu_torch.raster import binning, project
    proj = project.project_gaussians(*map(_t, sc[:3]), tc, cfg,
                                     opacities=_t(sc[3]))
    order = binning.depth_sort(proj).numpy()
    beyond = order[128:]
    assert int(proj.visible.sum()) > 128
    np.testing.assert_array_equal(got[4][beyond], 0.0)     # colors
    np.testing.assert_array_equal(got[3][beyond], 0.0)     # opacity
    np.testing.assert_array_equal(got[0][beyond], 0.0)     # means
    np.testing.assert_array_equal(want[4][beyond], 0.0)
    for name, a, b in zip(GRAD_NAMES, got, want):
        assert _rel_l2(a, b) <= 1e-3, (name, _rel_l2(a, b))


def test_grad_slab_bf16_accuracy(grad_refs, monkeypatch):
    """Mirror of test_grad_slab_bf16_accuracy: the bf16 slab's gradients
    stay within 1.5e-2 relative L2 of the f32 slab's."""
    sc, w2c, _ = grad_refs["uncapped"]
    cfg = TConfig(**CFG)
    g32 = _port_grads(sc, w2c, cfg, torch.float32, monkeypatch)
    g16 = _port_grads(sc, w2c, cfg, torch.bfloat16, monkeypatch)
    for name, a, b in zip(GRAD_NAMES, g16, g32):
        assert _rel_l2(a, b) < 1.5e-2, (name, _rel_l2(a, b))


def test_means2d_offset_grad():
    """Mirror of test_pallas_means2d_offset_grad: the offset's gradient is
    zero for culled Gaussians and non-zero for some visible ones."""
    sc = [_t(x) for x in make_scene(3, n=80)]
    _, tc = _cams()
    off = torch.zeros((80, 2), requires_grad=True)
    out = trasterize(*sc, tc, TConfig(**CFG), means2d_offset=off)
    (g,) = torch.autograd.grad(torch.sum(out.image ** 2), [off])
    radii = out.radii.numpy()
    g = g.numpy()
    assert np.all(g[radii == 0] == 0)
    assert np.any(np.abs(g[radii > 0]) > 0)
