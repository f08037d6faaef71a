"""Port parity for matching (match.frustum, match.hungarian, match.pnp,
match.superpoint) against the JAX package on the same numpy inputs. PnP's
random samples are JAX's own draws, computed here and injected into the
port."""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import transforms as jtransforms
from splatloc_tpu.match import frustum as jfrustum
from splatloc_tpu.match import hungarian as jhung
from splatloc_tpu.match import pnp as jpnp
from splatloc_tpu.match import superpoint as jsp
from splatloc_tpu_torch import convert
from splatloc_tpu_torch.match import frustum as tfrustum
from splatloc_tpu_torch.match import hungarian as thung
from splatloc_tpu_torch.match import pnp as tpnp
from splatloc_tpu_torch.match import superpoint as tsp

torch.set_num_threads(1)

K = np.array([[100.0, 0, 31.5], [0, 100.0, 23.5], [0, 0, 1]])
W, H = 64, 48


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# --------------------------------------------------------------------------
# frustum
# --------------------------------------------------------------------------

def _cloud(seed=0, n=400):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                    rng.uniform(-0.5, 4.0, n)], -1).astype(np.float32)
    marker = np.where(rng.uniform(size=n) < 0.6, 0.9, 0.0).astype(np.float32)
    c2w = np.asarray(jtransforms.se3_exp(jnp.asarray(
        [0.05, -0.03, 0.02, 0.02, -0.04, 0.01], jnp.float32)))
    return xyz, marker, c2w, np.linalg.inv(c2w).astype(np.float32)


def test_project_points_K_matches_jax():
    xyz, _, _, w2c = _cloud()
    uv_j, in_j = jfrustum.project_points_K(jnp.asarray(xyz), jnp.asarray(w2c),
                                           jnp.asarray(K, jnp.float32), W, H)
    uv_t, in_t = tfrustum.project_points_K(_t(xyz), _t(w2c), _t(K), W, H)
    np.testing.assert_array_equal(in_t.numpy(), np.asarray(in_j))
    ok = np.asarray(in_j)
    assert 50 < ok.sum() < len(ok)
    np.testing.assert_allclose(uv_t.numpy()[ok], np.asarray(uv_j)[ok],
                               rtol=1e-6, atol=1e-4)


def test_nearest_neighbor_matches_jax():
    """The same indices, with invalid points masked and more queries than
    a block; squared distances within 1e-5 (|q|^2 + |p|^2 - 2 q.p cancels:
    a few float32 ulps of the ~10 m^2 terms, summed in another order)."""
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (300, 3)).astype(np.float32)
    valid = rng.uniform(size=300) > 0.2
    q = (pts[rng.integers(0, 300, 1500)]
         + rng.normal(0, 0.05, (1500, 3))).astype(np.float32)
    dj, ij = jfrustum.nearest_neighbor(jnp.asarray(q), jnp.asarray(pts),
                                       jnp.asarray(valid), block=500)
    dt, it = tfrustum.nearest_neighbor(_t(q), _t(pts), torch.from_numpy(valid),
                                       block=512)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert valid[it.numpy()].all()
    np.testing.assert_allclose(dt.numpy() ** 2, np.asarray(dj) ** 2, rtol=0,
                               atol=1e-5)


def test_backproject_mask_matches_jax():
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(H, W)) > 0.9
    depth = rng.uniform(0.5, 3, (H, W)).astype(np.float32)
    _, _, c2w, _ = _cloud()
    np.testing.assert_array_equal(
        tfrustum.backproject_mask(mask, depth, K, c2w),
        jfrustum.backproject_mask(mask, depth, K, c2w))


@pytest.mark.parametrize("case", ["snap", "no_mask", "subset"])
def test_frustum_key_points_matches_jax(case):
    """The same rows (snapped Gaussians and their projections) as the JAX
    pipeline: the db mask marks projected key Gaussians, back-projected
    through a depth with noise, so some snap and some miss the radius."""
    xyz, marker, c2w, w2c = _cloud(3)
    rng = np.random.default_rng(4)
    kw = {}
    if case == "snap":
        uv, inside = jfrustum.project_points_K(
            jnp.asarray(xyz), jnp.asarray(w2c), jnp.asarray(K, jnp.float32),
            W, H)
        uv, inside = np.asarray(uv), np.asarray(inside)
        mask = np.zeros((H, W), bool)
        depth = np.zeros((H, W), np.float32)
        z = (xyz @ w2c[:3, :3].T + w2c[:3, 3])[:, 2]
        for i in np.nonzero(inside & (marker > 0))[0][:60]:
            u, v = np.round(uv[i]).astype(int).clip([0, 0], [W - 1, H - 1])
            mask[v, u] = True
            depth[v, u] = z[i] + rng.normal(0, 0.06)
        kw = dict(db_mask=mask, db_depth=depth, c2w=c2w)
    j = jfrustum.frustum_key_points(xyz, marker if case != "subset" else None,
                                    w2c, K, W, H, subset=case == "subset",
                                    **kw)
    t = tfrustum.frustum_key_points(xyz, marker if case != "subset" else None,
                                    w2c, K, W, H, subset=case == "subset",
                                    device="cpu", **kw)
    assert t[0].shape == j[0].shape and j[0].shape[0] > 5
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-6, atol=1e-4)
    if case == "snap":
        assert j[0].shape[0] < 60            # some miss the 0.1 m radius


# --------------------------------------------------------------------------
# hungarian
# --------------------------------------------------------------------------

def _descs(seed, D=32, n1=40, n2=60, noise=0.3):
    """Query descriptors that are noisy copies of a subset of the db's,
    plus distractors: the auction converges, sims straddle 0.4."""
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(D, n2)).astype(np.float32)
    src = rng.permutation(n2)[:n1]
    d1 = d2[:, src] + noise * rng.normal(size=(D, n1)).astype(np.float32)
    d1[:, : n1 // 4] = rng.normal(size=(D, n1 // 4))
    return d1.astype(np.float32), d2


def test_sim_matrix_matches_jax():
    d1, d2 = _descs(0, D=256, n1=300, n2=500)
    j = np.asarray(jhung._sim_matrix(jnp.asarray(d1), jnp.asarray(d2),
                                     jnp.float32(0.4)))
    t = thung._sim_matrix(_t(d1), _t(d2), 0.4).numpy()
    both = (j != 0) & (t != 0)
    assert (j == 0).mean() > 0.5 and both.sum() > 100
    # a value within 1e-6 of 0.4 may land on either side of the cut
    near = np.abs(np.maximum(j, t) - 0.4) < 1e-6
    np.testing.assert_array_equal((t != 0) | near, (j != 0) | near)
    np.testing.assert_allclose(t[~near], j[~near], rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(40, 60), (60, 40), (25, 25)])
def test_hungarian_same_assignment_as_jax(shape):
    """The same assignment and sims as the JAX auction (rows > columns
    takes the transposed path), and the scipy optimum's total similarity
    within n * eps."""
    n1, n2 = shape
    d1, d2 = _descs(10 + n1, n1=n1, n2=n2) if n1 <= n2 else _descs(
        10 + n1, n1=n2, n2=n1)[::-1]
    mj, sj = jhung.hungarian_solve(d1, d2)
    mt, st = thung.hungarian_solve(d1, d2, device="cpu")
    assert mt.shape == mj.shape == (2, min(n1, n2))
    assert (mj >= 0).all(), "the reference auction must converge here"
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    _, ss = thung.hungarian_solve(d1, d2, use_scipy=True)
    assert st.sum() >= ss.sum() - min(n1, n2) * 1e-4 - 1e-4


def test_hungarian_scipy_path_matches_jax():
    d1, d2 = _descs(3)
    mj, sj = jhung.hungarian_solve(d1, d2, use_scipy=True)
    mt, st = thung.hungarian_solve(_t(d1), d2, use_scipy=True)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(st, sj, atol=1e-6)


def test_hungarian_empty_and_identity():
    m, s = thung.hungarian_solve(np.zeros((16, 0)), np.zeros((16, 5)),
                                 device="cpu")
    assert m.shape == (2, 0) and s.shape == (0,)
    d = np.random.default_rng(5).normal(size=(16, 25)).astype(np.float32)
    m, s = thung.hungarian_solve(d, d, device="cpu")
    np.testing.assert_array_equal(m[0], m[1])
    assert (s > 0.99).all()


def test_auction_unconverged_wraps_like_jax():
    """Capped before convergence: -1 rows stay -1 and their sims read the
    last column, as the JAX package's take_along_axis wraps them."""
    d1, d2 = _descs(6, n1=30, n2=30, noise=1.0)
    sim_j = jhung._sim_matrix(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.float32(0.4))
    cj = np.asarray(jhung.auction_assignment(sim_j, eps=1e-4, n_iters=7))
    ct = thung.auction_assignment(_t(np.asarray(sim_j)), eps=1e-4, n_iters=7,
                                  block=3).numpy()
    assert (cj < 0).any()
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(
        thung._gather_wrapped(_t(np.asarray(sim_j)),
                              torch.from_numpy(ct)).numpy(),
        np.asarray(jnp.take_along_axis(sim_j, jnp.asarray(cj)[:, None],
                                       axis=1)[:, 0]))


@pytest.mark.parametrize("block", [1, 7, 20, 2000])
def test_auction_blocks_give_the_same_result(block):
    """Rounds in blocks with one host check per block: a converged state is
    a fixed point, so every block size gives one assignment."""
    d1, d2 = _descs(8, n1=50, n2=70)
    sim = thung._sim_matrix(_t(d1), _t(d2), 0.4)
    ref = thung.auction_assignment(sim, eps=1e-4, block=1)
    np.testing.assert_array_equal(
        thung.auction_assignment(sim, eps=1e-4, block=block).numpy(),
        ref.numpy())


# --------------------------------------------------------------------------
# PnP
# --------------------------------------------------------------------------

def _pnp_problem(seed, n=120, outlier_frac=0.3, noise=0.5):
    rng = np.random.default_rng(seed)
    Kp = np.array([[320.0, 0, 320], [0, 320, 240], [0, 0, 1]], np.float32)
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32)
    xi = np.array([0.1, -0.2, 0.05, 0.1, -0.05, 0.08], np.float32)
    T = np.asarray(jtransforms.se3_exp(jnp.asarray(xi)))
    cam = pts3d @ T[:3, :3].T + T[:3, 3]
    uv = cam[:, :2] / cam[:, 2:3] * 320.0 + np.array([320.0, 240.0])
    uv += rng.normal(0, noise, uv.shape)
    n_out = int(n * outlier_frac)
    uv[:n_out] += (rng.uniform(50, 200, (n_out, 2))
                   * rng.choice([-1, 1], (n_out, 2)))
    return uv.astype(np.float32), pts3d, Kp


def jax_priorities(seed: int, n_hypotheses: int, M: int) -> np.ndarray:
    """JAX's own RANSAC draws (pnp._solve_core): one uniform per point per
    hypothesis key."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hypotheses)
    return np.array(jax.vmap(lambda k: jax.random.uniform(k, (M,)))(keys))


@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_matches_jax_with_injected_draws(seed):
    """R, t within 1e-4 and the same inliers as the JAX solver, with JAX's
    draws injected (256 hypotheses to keep the test short)."""
    uv, pts3d, Kp = _pnp_problem(seed)
    nh = 256
    rj = jpnp.solve_pnp_ransac(uv, pts3d, Kp, n_hypotheses=nh, seed=seed)
    rt = tpnp.solve_pnp_ransac(uv, pts3d, Kp, n_hypotheses=nh,
                               priorities=jax_priorities(seed, nh, len(uv)),
                               device="cpu")
    assert rj["success"] and rt["success"]
    assert rt["num_inliers"] == rj["num_inliers"] > 60
    np.testing.assert_array_equal(rt["inliers"], rj["inliers"])
    np.testing.assert_allclose(rt["r"], rj["r"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt["t"], rj["t"], rtol=0, atol=1e-4)


def test_pnp_own_draws_recover_pose():
    """The port's own generator draws: the pose within 2 cm / 0.5 deg."""
    uv, pts3d, Kp = _pnp_problem(2, n=200)
    rt = tpnp.solve_pnp_ransac(uv, pts3d, Kp, n_hypotheses=256, seed=3,
                               device="cpu")
    T = np.asarray(jtransforms.se3_exp(jnp.asarray(
        [0.1, -0.2, 0.05, 0.1, -0.05, 0.08], jnp.float32)))
    Rc2w = T[:3, :3].T
    assert rt["success"]
    assert np.linalg.norm(rt["t"] - (-Rc2w @ T[:3, 3])) < 0.02
    cos = (np.trace(rt["r"].T @ Rc2w) - 1) / 2
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.5


@pytest.mark.parametrize("case", ["few", "coincident", "behind"])
def test_pnp_degenerate_cases_match_jax(case):
    """Fewer points than a sample; every point the same; every point
    behind the camera: neither package solves, with the same counts."""
    if case == "few":
        uv, p3 = np.zeros((3, 2), np.float32), np.zeros((3, 3), np.float32)
    elif case == "coincident":
        uv = np.full((20, 2), 100.0, np.float32)
        p3 = np.tile(np.array([[0.1, 0.2, 3.0]], np.float32), (20, 1))
    else:
        rng = np.random.default_rng(9)
        p3 = np.stack([rng.uniform(-1, 1, 30), rng.uniform(-1, 1, 30),
                       rng.uniform(-4, -2, 30)], -1).astype(np.float32)
        uv = rng.uniform(0, 640, (30, 2)).astype(np.float32)
    Kp = np.array([[320.0, 0, 320], [0, 320, 240], [0, 0, 1]], np.float32)
    nh = 64
    rj = jpnp.solve_pnp_ransac(uv, p3, Kp, n_hypotheses=nh)
    pri = jax_priorities(0, nh, len(uv)) if len(uv) >= 6 else None
    rt = tpnp.solve_pnp_ransac(uv, p3, Kp, n_hypotheses=nh, priorities=pri,
                               device="cpu")
    assert not rj["success"] and not rt["success"]
    assert rt["num_inliers"] == rj["num_inliers"]
    assert rt["r"] is None and rt["inliers"].shape == (len(uv),)


def test_dlt_pose_recovers_exact_pose():
    """Noise-free six points: the batched DLT gives the pose to 1e-4, like
    the JAX DLT."""
    uv, pts3d, Kp = _pnp_problem(4, n=6, outlier_frac=0.0, noise=0.0)
    n = np.stack([(uv[:, 0] - 320) / 320, (uv[:, 1] - 240) / 320], -1)
    Rj, tj, okj = jpnp._dlt_pose(jnp.asarray(n), jnp.asarray(pts3d))
    Rt, tt, okt = tpnp._dlt_pose(_t(n)[None], _t(pts3d)[None])
    assert bool(okj) and bool(okt[0])
    np.testing.assert_allclose(Rt[0].numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt[0].numpy(), np.asarray(tj), atol=1e-4)


def _fit_inputs(B, M, seed=5):
    """DLT hypotheses and normalized pairs as _solve_core makes them: every
    50th pair invalid, and hypothesis 1 (where B > 1) a DLT that failed."""
    uv, pts3d, _ = _pnp_problem(seed, n=M, outlier_frac=0.3 if M > 6 else 0.0)
    p2 = _t(np.stack([(uv[:, 0] - 320) / 320, (uv[:, 1] - 240) / 320], -1))
    p3 = _t(pts3d)
    valid = torch.ones(M, dtype=torch.bool)
    if M > 6:
        valid[::50] = False
    pri = torch.rand((B, M), generator=torch.Generator().manual_seed(seed))
    idx = torch.topk(pri + torch.where(valid, 0.0, -10.0), 6, dim=1).indices
    R, t, ok = tpnp._dlt_pose(p2[idx], p3[idx])
    t = t.contiguous()
    if B > 1:
        R[1], t[1], ok[1] = float("nan"), float("nan"), False
    return R, t, p2, p3, valid, ok, float(np.float32(12.0 / 320))


def _fit_as_before(R, t, p2, p3, valid, ok, thresh, final: bool):
    """The fits and scoring as _solve_core wrote them before they became
    one function: 5 iterations on the loose weights and the scores, then
    10 on the winner's strict inliers."""
    err = tpnp._reproj_errors(R, t, p2, p3)
    w = ((err < 3.0 * thresh) & valid).to(torch.float32)
    R, t = tpnp._gauss_newton_refine(R, t, p2, p3, w, 5)
    err = tpnp._reproj_errors(R, t, p2, p3)
    inl = (err < thresh) & valid
    score = torch.where(ok & torch.isfinite(t).all(1), inl.sum(1),
                        torch.full_like(inl.sum(1), -1))
    if not final:
        return R, t, score
    best = torch.argmax(score)
    R, t = R[best:best + 1], t[best:best + 1]
    err = tpnp._reproj_errors(R, t, p2, p3)
    w = ((err < thresh) & valid).to(torch.float32)
    R, t = tpnp._gauss_newton_refine(R, t, p2, p3, w, 10)
    err2 = tpnp._reproj_errors(R, t, p2, p3)
    inl2 = ((err2 < thresh) & valid)[0]
    return R, t, inl2, inl2.sum()


@pytest.mark.parametrize("final", [False, True], ids=["loose", "strict"])
@pytest.mark.parametrize("M", [6, 500])
@pytest.mark.parametrize("B", [1, 64])
def test_gauss_newton_fit_plain_is_the_fit_as_before(B, M, final):
    """The plain fit (and the wrapper, which runs it on CPU tensors) gives
    the fits and scores _solve_core computed before, bit for bit: every
    hypothesis on its loose weights, then the winner on its strict
    inliers."""
    R, t, p2, p3, valid, ok, thresh = _fit_inputs(B, M)
    want = _fit_as_before(R, t, p2, p3, valid, ok, thresh, final)
    for fit in (tpnp.gauss_newton_fit_plain, tpnp.gauss_newton_fit):
        got = fit(R, t, p2, p3, valid, thresh, 5, ok=ok)
        if final:
            got = fit(got[0], got[1], p2, p3, valid, thresh, 10,
                      best=torch.argmax(got[2]))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy(), w.numpy())
    if B > 1 and not final:
        assert int(want[2][1]) == -1 and int(want[2].max()) > 0


_BAD_FIT_ARGS = {
    "R_float64": lambda a: a.update(R=a["R"].double()),
    "t_shape": lambda a: a.update(t=a["t"][:, :2].contiguous()),
    "pts3d_not_contiguous": lambda a: a.update(
        pts3d=a["pts3d"].T.contiguous().T),
    "valid_uint8": lambda a: a.update(valid=a["valid"].to(torch.uint8)),
    "ok_and_best": lambda a: a.update(best=torch.tensor(0)),
    "neither_ok_nor_best": lambda a: a.pop("ok"),
    "best_not_0d": lambda a: (a.pop("ok"),
                              a.update(best=torch.tensor([0]))),
    "other_device": lambda a: a.update(
        valid=torch.ones(20, dtype=torch.bool, device="meta")),
}


@pytest.mark.parametrize("bad", list(_BAD_FIT_ARGS))
def test_gauss_newton_fit_checks_its_inputs(bad):
    R, t, p2, p3, valid, ok, thresh = _fit_inputs(4, 20)
    args = dict(R=R, t=t, pts2d_n=p2, pts3d=p3, valid=valid, ok=ok)
    _BAD_FIT_ARGS[bad](args)
    with pytest.raises(ValueError):
        tpnp.gauss_newton_fit(**args, thresh=thresh, iters=2)


class _CudaTagged(torch.Tensor):
    """A CPU tensor that reports a CUDA device: the fit's wrapper takes the
    card's path, while every other operation runs on the CPU."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_solve_core_on_cuda_launches_the_kernel_twice(monkeypatch):
    """On CUDA tensors (tagged, with the kernel's library mocked) the
    RANSAC's two fits are two launches, the hypotheses' with no index and
    the loose band, the winner's with the argmax's index, and the plain
    fit and its jacfwd never run."""
    calls = []

    def launch(*args):
        calls.append(args)
        return 0
    lib = types.SimpleNamespace(pnp_refine_launch=launch)
    monkeypatch.setattr(tpnp.build, "load", {"pnp_refine": lib}.__getitem__)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=7))

    def never(*a, **k):
        raise AssertionError("the plain fit ran on a CUDA tensor")
    for name in ("gauss_newton_fit_plain", "_gauss_newton_refine", "_jac"):
        monkeypatch.setattr(tpnp, name, never)
    _, _, p2, p3, valid, _, thresh = _fit_inputs(1, 50)
    pri = torch.rand((16, 50), generator=torch.Generator().manual_seed(0))

    def tag(x):
        return torch.Tensor._make_subclass(_CudaTagged, x)
    before = tpnp.gauss_newton_fit.launches
    R, t, inl, n, best = tpnp._solve_core(tag(p2), tag(p3), tag(valid),
                                          tag(pri), thresh, 6, 10)
    assert tpnp.gauss_newton_fit.launches - before == 2
    assert [type(x) for x in (R, t, inl, n, best)] == [_CudaTagged] * 5
    assert (tuple(R.shape), tuple(t.shape), tuple(inl.shape)) == (
        (3, 3), (3,), (50,))
    hyp, fin = calls
    # (R, t, ok, best, n_poses, pts2d, pts3d, valid, n_pairs,
    #  weight_thresh, thresh, iters, R_out, t_out, score, inliers, count,
    #  stream)
    assert hyp[2] is not None and hyp[3] is None and fin[3] is not None
    assert hyp[4] == fin[4] == 16 and hyp[8] == fin[8] == 50
    assert (hyp[9], hyp[10], hyp[11]) == (3.0 * thresh, thresh, 5)
    assert (fin[9], fin[10], fin[11]) == (thresh, thresh, 10)
    assert hyp[14] is not None and hyp[15] is None
    assert fin[14] is None and fin[15] is not None and fin[16] is not None
    assert hyp[17] == fin[17] == 7


# --------------------------------------------------------------------------
# SuperPoint
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sp_params():
    jp = jsp.init_params(jax.random.PRNGKey(0), desc_dim=64)
    return jp, convert.superpoint_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _image(seed=0, h=48, w=64):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, (h // 4, w // 4)).astype(np.float32)
    return np.kron(img, np.ones((4, 4), np.float32))      # blocky texture


def test_superpoint_dense_outputs_match_jax(sp_params):
    jp, tp = sp_params
    img = _image()
    sj, dj = jsp.dense_outputs(jp, jnp.asarray(img))
    st, dt = tsp.dense_outputs(tp, _t(img))
    assert st.shape == (48, 64) and dt.shape == (6, 8, 64)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-4)


@pytest.mark.parametrize("max_kp", [32, 4096])
def test_superpoint_extract_same_keypoints(sp_params, max_kp):
    """The same valid keypoints in the same order, scores and descriptors
    to 1e-4 (a budget past the frame's pixels takes them all)."""
    jp, tp = sp_params
    img = _image(1)
    j = jsp.extract(jp, jnp.asarray(img), max_keypoints=max_kp,
                    score_threshold=0.0)
    t = tsp.extract(tp, _t(img), max_keypoints=max_kp, score_threshold=0.0)
    vj = np.asarray(j["valid"])
    vt = t["valid"].numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() > 5
    np.testing.assert_array_equal(t["keypoints"].numpy()[vt],
                                  np.asarray(j["keypoints"])[vj])
    np.testing.assert_allclose(t["scores"].numpy()[vt],
                               np.asarray(j["scores"])[vj], atol=1e-4)
    np.testing.assert_allclose(t["descriptors"].numpy()[:, vt],
                               np.asarray(j["descriptors"])[:, vj],
                               atol=1e-4)


def test_superpoint_init_params_layout():
    p = tsp.init_params(torch.Generator().manual_seed(0), device="cpu")
    jp = jsp.init_params(jax.random.PRNGKey(0))
    assert set(p) == set(jp)
    for k, v in jp.items():
        shape = v.shape if v.ndim != 4 else (v.shape[3], v.shape[2],
                                             v.shape[0], v.shape[1])
        assert tuple(p[k].shape) == tuple(shape), k


def test_superpoint_load_params_reads_hwio(sp_params, tmp_path):
    jp, tp = sp_params
    path = str(tmp_path / "sp.npz")
    np.savez(path, **{k: np.asarray(v) for k, v in jp.items()})
    back = tsp.load_params(path, device="cpu")
    for k in tp:
        assert torch.equal(back[k], tp[k]), k
