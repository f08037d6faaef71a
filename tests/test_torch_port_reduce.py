"""Port parity of the per-Gaussian reduction (raster.hopper_raster
``seg_reduce``) on the CPU.

- ``seg_reduce`` against the JAX package's ``_reduce_to_gauss``, under
  both of its ``SEGSCAN_MODE``s, on pair tables from ``build_pairs`` (with
  dropped pairs and with a ``visible_cap``) and on random permutations of
  synthetic runs.
- A model of the sort-free contract the CUDA kernel implements (the count
  of each rank's surviving pairs, their exclusive prefix sum S, the run-end
  test at ``at``, the first ``at - S[r] + 1`` positions in ascending order)
  against ``seg_reduce_plain``, which sorts: over drop rates and run
  lengths up to kmax, and on counts below the surviving pairs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.raster import pallas_raster as jpr
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import RasterConfig, binning, hopper_raster
from splatloc_tpu_torch.raster import pairs, project

torch.set_num_threads(1)

W, H = 64, 48
ROWS = 16                      # the table's rows at C = 4


def table_case(seed, dense=False, **cfg_kw):
    """(pair_idx, per_rank_counts, kmax) of one view, as a render builds
    them (port's build_pairs, bit-identical to the JAX package's)."""
    rng = np.random.default_rng(seed)
    n = 300
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    lo, hi = (-3.0, -1.8) if dense else (-4.5, -2.5)
    scales = np.exp(rng.uniform(lo, hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.6 if dense else 0.2, 0.95, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)
    t = [torch.from_numpy(x) for x in (means, scales, quats, opac, colors)]
    cfg = RasterConfig(use_pallas=True, **cfg_kw)
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device="cpu")
    proj = project.project_gaussians(*t[:3], cam, cfg, opacities=t[3])
    _, pr, _ = hopper_raster._pair_inputs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c), t[3],
        proj.depth, t[4], (proj.radius_x, proj.radius_y), proj.visible,
        binning.depth_sort(proj), W, H, cfg)
    return (pr["pair_idx"], pr["per_rank_counts"],
            pairs.big_tiles_for(cfg, W, H), int(pr["n_dropped"]))


def runs_case(seed, K, long_run, drop, sentinels=300):
    """Synthetic ids: rank r emits counts[r] pairs (rank 3 and rank K / 2 +
    3 ``long_run``), a fraction ``drop`` of the upper half's pairs is lost
    after the counts were taken (a drop invalidates every later run end,
    so the lower half stays valid), the survivors and ``sentinels`` filler
    ids K lie in a random order."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, K)
    counts[3] = counts[K // 2 + 3] = long_run
    ids = np.repeat(np.arange(K), counts)
    ids = ids[(ids < K // 2) | (rng.uniform(size=ids.shape[0]) >= drop)]
    ids = rng.permutation(np.concatenate([ids, np.full(sentinels, K)]))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)))


def slab_for(pc, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(pc, ROWS)).astype(
        np.float32)).to(dtype)


def sort_free_model(slab, pair_idx, per_rank_counts):
    """The reduction as csrc/seg_reduce.cu states it, with no sort: cnt[r]
    the positions holding id r < K, S its exclusive prefix sum, E the
    inclusive prefix sum of the emitted counts, at = clip(E - 1, 0, PC - 1);
    rank r sums (in float32, in ascending position order) the rows of its
    first at - S[r] + 1 positions where S[r] <= at < S[r] + cnt[r], else
    gets zeros."""
    PC = pair_idx.shape[0]
    K = per_rank_counts.shape[0]
    ids = pair_idx.long()
    mine = ids < K
    cnt = torch.bincount(ids[mine], minlength=K)
    S = torch.cumsum(cnt, 0) - cnt
    at = torch.clamp(torch.cumsum(per_rank_counts.long(), 0) - 1, 0, PC - 1)
    x = slab.float()
    out = torch.zeros((K, slab.shape[1]))
    for r in range(K):
        if S[r] <= at[r] < S[r] + cnt[r]:
            pos = torch.nonzero(ids == r)[:, 0][:int(at[r] - S[r] + 1)]
            acc = torch.zeros(slab.shape[1])
            for p in pos.tolist():
                acc = acc + x[p]
            out[r] = acc
    return out


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

TABLES = {
    "default": dict(seed=0),
    "pairs_dropped": dict(seed=1, dense=True, pair_cap_override=128),
    "visible_cap": dict(seed=2, visible_cap=128),
    "giant_tiers": dict(seed=3, dense=True, max_tiles=4, big_k=8),
}
RANDOM = {
    "random_runs": dict(seed=4, K=400, long_run=48, drop=0.0),
    "random_runs_dropped": dict(seed=5, K=400, long_run=48, drop=0.2),
}


def _case(name):
    if name in TABLES:
        pair_idx, prc, kmax, dropped = table_case(**TABLES[name])
        if name == "pairs_dropped":
            assert dropped > 0
        return pair_idx, prc, kmax
    pair_idx, prc = runs_case(**RANDOM[name])
    return pair_idx, prc, int(prc.max())


@pytest.mark.parametrize("mode", ["pallas", "xla"])
@pytest.mark.parametrize("case", list(TABLES) + list(RANDOM))
def test_reduce_to_gauss_matches_jax(case, mode, monkeypatch):
    """The port's reduction (the plain path on the CPU) against JAX's
    _reduce_to_gauss on the same slab (rtol 1e-5): the sums, and the ranks
    that get zeros."""
    monkeypatch.setattr(jpr, "SEGSCAN_MODE", mode)
    pair_idx, prc, kmax = _case(case)
    K = prc.shape[0]
    slab = slab_for(pair_idx.shape[0], 7)
    pad = np.zeros((slab.shape[0], 128), np.float32)
    pad[:, :ROWS] = slab.numpy()
    want = np.asarray(jpr._reduce_to_gauss(
        jnp.asarray(pad), jnp.asarray(pair_idx.numpy()),
        jnp.asarray(prc.numpy()), K, 4, kmax, True))
    got = hopper_raster.seg_reduce(slab, pair_idx, prc, kmax).numpy()
    assert got.shape == want.shape == (K, ROWS)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert np.abs(got).max() > 0


# ---------------------------------------------------------------------------
# the sort-free contract against the sorting plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drop", [0.0, 0.1, 0.5])
@pytest.mark.parametrize("long_run", [1, 12, 192, 1200, 5000])
def test_sort_free_contract_matches_plain(drop, long_run):
    """The contract the kernel implements gives what the sorting plain
    version gives (the same float32 values summed in another order: rtol
    1e-5), with runs up to kmax (the longest emitted count; 5000 is past
    the kernel's bucket of 4096 pairs) and drops.
    With nothing dropped every rank with pairs is valid and sums its whole
    run; with drops some ranks get zeros."""
    pair_idx, prc = runs_case(11, 300, long_run, drop)
    kmax = int(prc.max())
    slab = slab_for(pair_idx.shape[0], 12, torch.bfloat16)
    want = hopper_raster.seg_reduce_plain(slab, pair_idx, prc, kmax)
    got = sort_free_model(slab, pair_idx, prc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got == 0, want == 0)
    has_pairs = prc > 0
    if drop == 0.0:
        assert bool((want[has_pairs] != 0).any(dim=1).all())
    else:
        assert bool((want[has_pairs] == 0).all(dim=1).any())


@pytest.mark.parametrize("seed", [0, 1])
def test_sort_free_contract_on_short_counts(seed):
    """Counts below the surviving pairs (never from build_pairs: the
    kernel's slow path) shift the run ends into other runs: some ranks then
    sum a part of their run. The contract still gives the plain version's
    result."""
    pair_idx, prc = runs_case(20 + seed, 200, 30, 0.0, sentinels=0)
    prc = prc.clone()
    prc[::7] = torch.clamp(prc[::7] - 3, min=0)
    kmax = int(prc.max())
    slab = slab_for(pair_idx.shape[0], 21)
    want = hopper_raster.seg_reduce_plain(slab, pair_idx, prc, kmax)
    got = sort_free_model(slab, pair_idx, prc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got == 0, want == 0)


def test_reduce_empty_ranks_and_all_sentinels():
    """K = 0 gives a [0, rows] result; an all-sentinel pair array gives
    zero rows; an empty pair array raises."""
    slab = slab_for(256, 3)
    got = hopper_raster.seg_reduce(slab, torch.zeros(256, dtype=torch.int32),
                                   torch.zeros(0, dtype=torch.int32), 192)
    assert got.shape == (0, ROWS)
    K = 50
    prc = torch.from_numpy(np.random.default_rng(4).integers(
        0, 6, K).astype(np.int32))
    got = hopper_raster.seg_reduce(slab, torch.full((256,), K,
                                                    dtype=torch.int32),
                                   prc, 192)
    assert got.shape == (K, ROWS) and bool((got == 0).all())
    with pytest.raises(ValueError, match="empty"):
        hopper_raster.seg_reduce(slab[:0], torch.zeros(0, dtype=torch.int32),
                                 prc, 192)
