"""Card-only tests of the port's CUDA kernels: each kernel against its plain
PyTorch version at a small size. They skip where no CUDA device is present.

They import no JAX, so they also run on a machine without it; there, run
them without the suite's conftest (which imports JAX):

    python -m pytest tests/test_torch_port_cuda.py --noconftest -q
"""
import numpy as np
import pytest
import torch

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, hopper_raster, project
from splatloc_tpu_torch.raster import RasterConfig, rasterize, render
from splatloc_tpu_torch.scene.gaussians import GaussianScene

pytestmark = pytest.mark.cuda

W, H = 64, 48
# the limits chip_smoke.py holds the kernel to (see its TOL note)
CH_MAX, DEPTH_MAX, T_MAX, NC_EQUAL = 2e-4, 2e-3, 1e-5, 0.999


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def make_scene(seed, n=300, channels=4, dense=False):
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                      rng.uniform(1, 5, n)], -1).astype(np.float32)
    lo, hi = (-3.0, -1.8) if dense else (-4.5, -2.5)
    scales = np.exp(rng.uniform(lo, hi, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.6 if dense else 0.2, 0.97, n).astype(np.float32)
    colors = rng.uniform(0, 1, (n, channels)).astype(np.float32)
    return [torch.from_numpy(x) for x in (means, scales, quats, opac,
                                          colors)]


def walk_inputs(sc, cfg):
    """The walk's inputs on the CPU, as rasterize builds them."""
    means, scales, quats, opac, colors = sc
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device="cpu")
    proj = project.project_gaussians(means, scales, quats, cam, cfg,
                                     opacities=opac)
    order = binning.depth_sort(proj)
    gpair, pr, origins = hopper_raster._pair_inputs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c), opac,
        proj.depth, colors, (proj.radius_x, proj.radius_y), proj.visible,
        order, W, H, cfg)
    return gpair, pr["starts"], pr["counts"], origins


def assert_walks_agree(got, ref, C):
    d = (got - ref).abs()
    assert float(d[:, :C].max()) <= CH_MAX
    assert float(d[:, C + 1].max()) <= CH_MAX
    assert float(d[:, C].max()) <= DEPTH_MAX
    assert float(d[:, C + 3].max()) <= T_MAX
    assert float((got[:, C + 2] == ref[:, C + 2]).float().mean()) >= NC_EQUAL


CASES = {
    "default": (dict(), dict()),
    "dense_saturating": (dict(dense=True), dict()),
    "eight_channels": (dict(channels=8), dict()),
    "tile_8": (dict(), dict(tile_size=8)),
    "visible_cap": (dict(), dict(visible_cap=128)),
    # segments of up to ~360 pairs: many 64-pair stages, most ending mid-stage
    "long_segments": (dict(n=1200), dict()),
    # the other tile sizes the CUDA walks take
    "tile_24": (dict(), dict(tile_size=24)),
    "tile_32": (dict(n=1200), dict(tile_size=32)),
    # one channel, and the instantiations for 9-16 and 17-24 channels
    "one_channel": (dict(channels=1), dict()),
    "sixteen_channels": (dict(channels=16), dict()),
    "max_channels": (dict(channels=24), dict()),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cuda, case):
    scene_kw, cfg_kw = CASES[case]
    sc = make_scene(0, **scene_kw)
    cfg = RasterConfig(use_pallas=True, **cfg_kw)
    C = sc[4].shape[1]
    args = walk_inputs(sc, cfg)
    ref_cpu = hopper_raster.fwd_pairwalk_plain(*args, C, cfg)
    args_d = [a.to(cuda) for a in args]
    before = hopper_raster.fwd_pairwalk.launches
    got = hopper_raster.fwd_pairwalk(*args_d, C, cfg)
    torch.cuda.synchronize()
    assert hopper_raster.fwd_pairwalk.launches == before + 1
    ref = hopper_raster.fwd_pairwalk_plain(*args_d, C, cfg)
    assert_walks_agree(got.cpu(), ref.cpu(), C)
    assert_walks_agree(got.cpu(), ref_cpu, C)
    if case == "dense_saturating":
        assert bool((got[:, C + 3] < 1e-3).any())      # early exit reached


def test_kernel_empty_tiles_and_zero_tiles(cuda):
    """Tiles with no pairs (starts clamped to the capacity) read nothing and
    write the empty-pixel values; a zero-tile launch is a no-op."""
    sc = make_scene(1, n=20)
    cfg = RasterConfig(use_pallas=True)
    args = [a.to(cuda) for a in walk_inputs(sc, cfg)]
    counts = args[2]
    assert bool((counts == 0).any())
    got = hopper_raster.fwd_pairwalk(*args, 4, cfg)
    empty = (counts == 0).nonzero()[:, 0]
    e = got[empty]
    assert bool((e[:, :6] == 0).all())
    assert bool((e[:, 6] == -1).all()) and bool((e[:, 7] == 1).all())
    none = [args[0], args[1][:0], args[2][:0], args[3][:0]]
    assert hopper_raster.fwd_pairwalk(*none, 4, cfg).shape == (0, 8, 256)


def test_kernel_rejects_bad_inputs(cuda):
    sc = make_scene(2, n=50)
    cfg = RasterConfig(use_pallas=True)
    gpair, starts, counts, origins = [a.to(cuda) for a in
                                      walk_inputs(sc, cfg)]
    before = hopper_raster.fwd_pairwalk.launches
    with pytest.raises(ValueError, match="contiguous"):
        hopper_raster.fwd_pairwalk(gpair.t().contiguous().t(), starts,
                                   counts, origins, 4, cfg)
    with pytest.raises(ValueError):
        hopper_raster.fwd_pairwalk(gpair, starts.cpu(), counts, origins, 4,
                                   cfg)
    assert hopper_raster.fwd_pairwalk.launches == before


def test_render_on_card_matches_cpu(cuda):
    """The whole render on the card against the CPU path."""
    rng = np.random.default_rng(3)
    n = 400
    op = rng.uniform(0.2, 0.95, (n, 1))
    fields = {
        "xyz": np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                         rng.uniform(1, 5, n)], -1),
        "f_dc": rng.normal(scale=0.5, size=(n, 1, 3)),
        "f_rest": np.zeros((n, 0, 3)),
        "scaling": rng.uniform(-4.5, -2.5, (n, 3)),
        "rotation": rng.normal(size=(n, 4)),
        "opacity": np.log(op / (1 - op)),
        "marker": np.zeros((n, 1)),
        "kp_score": rng.uniform(0, 1, (n, 1)),
    }
    outs = {}
    for dev in ("cpu", cuda):
        scene = GaussianScene(
            alive=torch.ones(n, dtype=torch.bool, device=dev), sh_degree=0,
            **{k: torch.tensor(v, dtype=torch.float32, device=dev)
               for k, v in fields.items()})
        cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0,
                            W / 2, H / 2, W, H, device=dev)
        outs[str(dev)] = render(scene, cam, RasterConfig(use_pallas=True))
    got, ref = outs[str(cuda)], outs["cpu"]
    for k, atol in (("render", CH_MAX), ("kp_prob", CH_MAX),
                    ("opacity", CH_MAX), ("depth", DEPTH_MAX)):
        assert float((got[k].cpu() - ref[k]).abs().max()) <= atol, k
    for k in ("radii", "visibility_filter"):
        assert torch.equal(got[k].cpu(), ref[k]), k


# --------------------------------------------------------------------------
# the backward walk (bwd_pairwalk) and the reduction (seg_reduce)
# --------------------------------------------------------------------------

def bwd_inputs(sc, cfg, seed=0):
    """The backward walk's inputs on the CPU: the forward's, its output,
    a seeded cotangent and jhi. A table of more than 32 rows (24 channels
    and the rect rows) is cut to its first 32, which hold every row the
    walks read."""
    gpair, starts, counts, origins = walk_inputs(sc, cfg)
    gpair = gpair[:32].contiguous()
    C = sc[4].shape[1]
    out = hopper_raster.fwd_pairwalk_plain(gpair, starts, counts, origins,
                                           C, cfg)
    g = torch.Generator().manual_seed(seed)
    cot = torch.randn((out.shape[0], C + 2, out.shape[2]), generator=g)
    jhi = hopper_raster._jhi(out, starts, counts, C)
    return [gpair, starts, counts, origins, jhi, out, cot]


def segment_mask(starts, counts, pc):
    mask = torch.zeros(pc, dtype=torch.bool)
    for s, c in zip(starts.tolist(), counts.tolist()):
        mask[s:s + -(-c // 128) * 128] = True
    return mask


def rel_l2(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def poisoned(shape, dtype, device):
    """The address of a freed NaN-filled block of ``shape``: the caching
    allocator hands it to the next allocation of that size, so a kernel's
    torch.empty output starts out as NaN."""
    x = torch.full(shape, float("nan"), dtype=dtype, device=device)
    ptr = x.data_ptr()
    del x
    return ptr


def assert_bwd_matches_plain(args, C, cfg, dtype, cuda):
    """K2 on ``args`` (CPU tensors) against its plain version, into a slab
    that held NaN: every gradient row within 1e-4 relative L2 (f32 slab) or
    1e-2 (bf16), pad rows and rows past jhi exactly zero. Returns the
    kernel's slab on the CPU."""
    ref = hopper_raster.bwd_pairwalk_plain(*args, C, cfg, dtype).float()
    args_d = [a.to(cuda) for a in args]
    ptr = poisoned(ref.shape, dtype, cuda)
    before = hopper_raster.bwd_pairwalk.launches
    got = hopper_raster.bwd_pairwalk(*args_d, C, cfg, dtype)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr and got.dtype == dtype
    assert hopper_raster.bwd_pairwalk.launches == before + 1
    mask = segment_mask(args[1], args[2], ref.shape[0])
    g, r = got.float().cpu()[mask], ref[mask]
    assert bool(torch.isfinite(g).all())
    limit = 1e-4 if dtype == torch.float32 else 1e-2
    for row in range(hopper_raster.N_FIXED + C):
        assert rel_l2(g[:, row], r[:, row]) <= limit, row
    assert bool((g[:, hopper_raster.N_FIXED + C:] == 0).all())
    zero = ~segment_mask(args[1], args[1] * 0 + (args[4] + 1) * 128,
                         ref.shape[0]) & mask
    assert bool((got.float().cpu()[zero] == 0).all())
    return got.cpu()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_matches_plain(cuda, case, dtype):
    """K2 against its plain version (assert_bwd_matches_plain) on each
    case's scene."""
    scene_kw, cfg_kw = CASES[case]
    sc = make_scene(4, **scene_kw)
    cfg = RasterConfig(use_pallas=True, **cfg_kw)
    C = sc[4].shape[1]
    assert_bwd_matches_plain(bwd_inputs(sc, cfg), C, cfg, dtype, cuda)


def test_bwd_kernel_uneven_warps_jhi_and_empty_tiles(cuda):
    """K2 where the warps of a tile stop at very different pairs (the warp
    skip), on a tile whose jhi is -1 though it has pairs (its whole segment
    is zero-filled) and beside tiles with no pairs."""
    sc = make_scene(8, n=1200)
    cfg = RasterConfig(use_pallas=True)
    C = 4
    args = bwd_inputs(sc, cfg)
    gpair, starts, counts, origins, jhi, out, cot = args
    out = out.clone()
    nc = out[:, C + 2]                                   # [T, P] view
    # warp w (64 pixels) keeps the first fraction f_w of its pixels' walk;
    # the last pixel of each warp blends nothing
    frac = torch.tensor([1.0, 0.5, 0.1, 0.0]).repeat_interleave(64)
    walked = torch.clamp(nc - starts[:, None], min=-1)
    nc.copy_(torch.where(nc >= 0, starts[:, None] + torch.floor(
        walked * frac[None, :]), nc))
    nc.view(-1, 4, 64)[:, :, -1] = -1
    counts = counts.clone()
    counts[0] = 0                                        # an empty tile
    jhi = hopper_raster._jhi(out, starts, counts, C)
    busy = int(torch.argmax(counts))
    assert busy != 0 and int(jhi[busy]) >= 1
    jhi[busy] = -1
    args = [gpair, starts, counts, origins, jhi, out, cot]
    got = assert_bwd_matches_plain(args, C, cfg, torch.float32, cuda)
    s0 = int(starts[busy])
    assert bool((got[s0:s0 + -(-int(counts[busy]) // 128) * 128] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernel_repeats_bit_for_bit(cuda, dtype):
    """Two K2 launches on the same inputs write the same slab, bit for
    bit (no atomics, every sum in a fixed order)."""
    sc = make_scene(9, n=1200)
    cfg = RasterConfig(use_pallas=True)
    args = [a.to(cuda) for a in bwd_inputs(sc, cfg)]
    a = hopper_raster.bwd_pairwalk(*args, 4, cfg, dtype)
    b = hopper_raster.bwd_pairwalk(*args, 4, cfg, dtype)
    mask = segment_mask(args[1].cpu(), args[2].cpu(), a.shape[0]).to(cuda)
    assert torch.equal(a[mask], b[mask])


@pytest.mark.parametrize("ts", [4, 12, 20])
def test_walks_reject_tile_sizes_they_do_not_take(cuda, ts):
    """On the card the walks take tile sizes 8, 16, 24 and 32 (two pixels
    of a row per thread, whole warps) and raise for the rest, before any
    launch; the CPU path takes them."""
    sc = make_scene(10, n=100)
    cfg = RasterConfig(use_pallas=True, tile_size=ts)
    args = bwd_inputs(sc, cfg)
    before = (hopper_raster.fwd_pairwalk.launches,
              hopper_raster.bwd_pairwalk.launches)
    d = [a.to(cuda) for a in args]
    with pytest.raises(ValueError, match="tile_size"):
        hopper_raster.fwd_pairwalk(*d[:4], 4, cfg)
    with pytest.raises(ValueError, match="tile_size"):
        hopper_raster.bwd_pairwalk(*d, 4, cfg)
    assert (hopper_raster.fwd_pairwalk.launches,
            hopper_raster.bwd_pairwalk.launches) == before


def _runs(seed, K, long_run, drop, sentinels=300):
    """Pair ids in a random order with run lengths from ``seed`` (ranks 3
    and K / 2 + 3 emit ``long_run`` pairs), ``sentinels`` filler ids K, and
    the per-rank emitted counts; with ``drop``, a tenth of the upper half's
    pairs is lost after the counts were taken (the reference's
    dropped-pair case: every later run end misses its run)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 12, K)
    counts[3] = counts[K // 2 + 3] = long_run
    ids = np.repeat(np.arange(K), counts)
    if drop:
        keep = (ids < K // 2) | (rng.uniform(size=ids.shape[0]) > 0.1)
        ids = ids[keep]
    ids = rng.permutation(np.concatenate([ids, np.full(sentinels, K)]))
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int32)))


def seg_case(seed, K, long_run, drop, dtype, rows=16, sentinels=300):
    """The reduction's inputs on the CPU: pair ids, emitted counts and a
    slab whose rows of filler ids are NaN (they must reach no rank)."""
    pair_idx, prc = _runs(seed, K, long_run, drop, sentinels)
    rng = np.random.default_rng(seed + 1)
    slab = torch.from_numpy(rng.normal(size=(pair_idx.shape[0], rows))
                            .astype(np.float32))
    slab[pair_idx == K] = float("nan")
    return slab.to(dtype), pair_idx, prc


def assert_seg_matches_plain(args, kmax, cuda):
    """K3 on CPU ``args`` against its plain version (relative L2 1e-5, the
    same zero rows), one launch counted per call, and a second launch bit
    for bit the first. Returns the plain result."""
    ref = hopper_raster.seg_reduce_plain(*args, kmax)
    d = [a.to(cuda) for a in args]
    before = hopper_raster.seg_reduce.launches
    got = hopper_raster.seg_reduce(*d, kmax)
    again = hopper_raster.seg_reduce(*d, kmax)
    torch.cuda.synchronize()
    assert hopper_raster.seg_reduce.launches == before + 2
    assert torch.equal(got, again)
    got = got.cpu()
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(ref).all())
    assert rel_l2(got, ref) <= 1e-5
    assert torch.equal(got == 0, ref == 0)
    return ref


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_reduce_kernel_matches_plain(cuda, dtype, drop):
    """K3 against its plain version (assert_seg_matches_plain) on runs
    longer than any bucket (20,000 pairs of one rank: the slow path) and,
    with ``drop``, on dropped pairs; the slab's filler rows are NaN."""
    kmax = 20_000
    ref = assert_seg_matches_plain(seg_case(5, 500, kmax, drop, dtype),
                                   kmax, cuda)
    assert float(ref[3].abs().max()) > 0    # the long run was summed
    if drop:
        # run ends that miss their own run give zero rows
        assert bool((ref[250:] == 0).all(dim=1).any())


@pytest.mark.parametrize("rows", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("long_run", [1, 9, 192, 1200])
def test_seg_reduce_rows_and_run_lengths(cuda, rows, dtype, long_run):
    """Every row count and slab dtype (the 16-byte row split differs), long
    runs on the short path (up to 8 pairs) and on the warp path, several
    chunks of 256 ranks."""
    args = seg_case(7, 1500, long_run, False, dtype, rows)
    assert_seg_matches_plain(args, max(long_run, 12), cuda)


@pytest.mark.parametrize("long_run", [4096, 4097])
def test_seg_reduce_runs_at_the_bucket_size(cuda, long_run):
    """A run that just fills a rank's bucket (4096 pairs, staged and
    ordered in shared memory) and one a pair longer (summed by scanning
    pair_idx)."""
    args = seg_case(6, 700, long_run, False, torch.bfloat16)
    assert_seg_matches_plain(args, long_run, cuda)


def test_seg_reduce_many_staging_windows(cuda):
    """Chunks whose buckets hold more entries than one staging window
    (4096): every rank has a run of 40."""
    K = 600
    ids = np.random.default_rng(8).permutation(np.repeat(np.arange(K), 40))
    slab = torch.from_numpy(np.random.default_rng(9).normal(
        size=(ids.shape[0], 16)).astype(np.float32))
    assert_seg_matches_plain([slab, torch.from_numpy(ids.astype(np.int32)),
                              torch.full((K,), 40, dtype=torch.int32)],
                             40, cuda)


def test_seg_reduce_short_counts_take_the_slow_path(cuda):
    """Emitted counts below the surviving pairs (never from build_pairs):
    the buckets cannot hold those runs, and the kernel sums them by
    scanning pair_idx; it still gives the plain version's result, partial
    runs included."""
    slab, pair_idx, prc = seg_case(10, 400, 30, False, torch.float32,
                                   sentinels=0)
    prc = prc.clone()
    prc[::7] = torch.clamp(prc[::7] - 3, min=0)
    assert_seg_matches_plain([slab, pair_idx, prc], 30, cuda)


def test_seg_reduce_edge_cases(cuda):
    """K = 0; an all-sentinel pair array (zero rows); more ranks than the
    kernel takes (2^20) make the launch fail, and it is not counted."""
    slab = torch.randn(512, 16, device=cuda)
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    got = hopper_raster.seg_reduce(slab, torch.zeros(512, dtype=torch.int32,
                                                     device=cuda), none, 12)
    assert got.shape == (0, 16)
    prc = torch.full((300,), 3, dtype=torch.int32, device=cuda)
    sent = torch.full((512,), 300, dtype=torch.int32, device=cuda)
    got = hopper_raster.seg_reduce(slab, sent, prc, 12)
    torch.cuda.synchronize()
    assert bool((got == 0).all())
    before = hopper_raster.seg_reduce.launches
    many = torch.ones(((1 << 20) + 1,), dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="seg_reduce launch failed"):
        hopper_raster.seg_reduce(slab, sent, many, 12)
    assert hopper_raster.seg_reduce.launches == before


def test_seg_reduce_on_card_sorts_nothing(cuda, monkeypatch):
    """The CUDA path of the reduction (the port's _reduce_to_gauss) calls
    no torch.sort (patched to raise) and matches the plain version."""
    slab, pair_idx, prc = seg_case(12, 800, 40, True, torch.bfloat16)
    ref = hopper_raster.seg_reduce_plain(slab, pair_idx, prc, 40)
    d = [slab.to(cuda), pair_idx.to(cuda), prc.to(cuda)]

    def no_sort(*a, **k):
        raise AssertionError("torch.sort called")
    monkeypatch.setattr(torch, "sort", no_sort)
    got = hopper_raster.seg_reduce(*d, 40)
    torch.cuda.synchronize()
    assert rel_l2(got.cpu(), ref) <= 1e-5


def test_rasterize_grads_on_card_match_cpu(cuda):
    """The whole backward through rasterize on the card (K2 and K3 on the
    main path) against the CPU path: every gradient within 1e-3 relative
    L2, f32 slabs on both."""
    old = hopper_raster.GRAD_SLAB_DTYPE
    hopper_raster.GRAD_SLAB_DTYPE = torch.float32
    try:
        grads = {}
        for dev in ("cpu", cuda):
            sc = [x.to(dev).requires_grad_(True) for x in make_scene(7)]
            cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0,
                                W / 2, H / 2, W, H, device=dev)
            out = rasterize(*sc, cam, RasterConfig(use_pallas=True))
            loss = (out.image ** 2).mean() + 0.05 * out.depth.mean()
            grads[str(dev)] = [g.cpu() for g in torch.autograd.grad(loss, sc)]
    finally:
        hopper_raster.GRAD_SLAB_DTYPE = old
    for a, b in zip(grads[str(cuda)], grads["cpu"]):
        assert bool(torch.isfinite(a).all())
        assert rel_l2(a, b) <= 1e-3
