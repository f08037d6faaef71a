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
from splatloc_tpu_torch.utils.profiling import count_syncs

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


# --------------------------------------------------------------------------
# localization on the card against the CPU path
# --------------------------------------------------------------------------

def test_decode_on_card_matches_cpu(cuda):
    """The descriptor field at the Replica width (16 x 2^19 grid, 4 x 128
    -> 256) on the card within 1e-4 of the CPU path (bf16 operands after
    float32 sums taken in another order; see chip_smoke.CARD_CPU_LIMITS)."""
    from splatloc_tpu_torch.fields import FeatureFieldConfig, decode
    from splatloc_tpu_torch.fields import init_decoder
    cfg = FeatureFieldConfig(bound=((-1.0, 7.0), (-1.3, 3.7), (-1.7, 1.4)))
    p = init_decoder(cfg, torch.Generator().manual_seed(0), device="cpu")
    p["table"] = p["table"] * 5000.0           # a trained table's scale
    rng = np.random.default_rng(1)
    pos = torch.from_numpy(np.stack(
        [rng.uniform(-1, 7, 2000), rng.uniform(-1.3, 3.7, 2000),
         rng.uniform(-1.7, 1.4, 2000)], -1).astype(np.float32))
    ref = decode(p, pos, cfg)
    got = decode({"table": p["table"].to(cuda),
                  "layers": [w.to(cuda) for w in p["layers"]]},
                 pos.to(cuda), cfg)
    assert float((got.cpu() - ref).abs().max()) <= 1e-4


def test_auction_on_card_matches_cpu(cuda):
    """The auction on one similarity matrix: the same assignment on both
    devices (elementwise arithmetic and maxima only), in blocks of rounds,
    rows > columns included."""
    from splatloc_tpu_torch.match import hungarian
    rng = np.random.default_rng(2)
    d2 = rng.normal(size=(64, 300)).astype(np.float32)
    d1 = d2[:, rng.permutation(300)[:200]] + 0.4 * rng.normal(
        size=(64, 200)).astype(np.float32)
    for a, b in ((d1, d2), (d2, d1)):
        sim = hungarian._sim_matrix(torch.from_numpy(a), torch.from_numpy(b),
                                    0.4)
        if sim.shape[0] > sim.shape[1]:
            sim = sim.T.contiguous()
        ref = hungarian.auction_assignment(sim, eps=1e-4)
        got = hungarian.auction_assignment(sim.to(cuda), eps=1e-4)
        assert torch.equal(got.cpu(), ref)
        sc = hungarian._sim_matrix(torch.from_numpy(a).to(cuda),
                                   torch.from_numpy(b).to(cuda), 0.4)
        s0 = hungarian._sim_matrix(torch.from_numpy(a), torch.from_numpy(b),
                                   0.4)
        assert float((sc.cpu() - s0).abs().max()) <= 1e-6


def test_pnp_on_card_matches_cpu(cuda):
    """PnP with one set of injected priorities: R, t within 1e-4 and the
    same inliers on both devices."""
    from splatloc_tpu_torch.match import pnp
    rng = np.random.default_rng(3)
    n = 300
    pts3d = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                      rng.uniform(2, 6, n)], -1).astype(np.float32)
    uv = pts3d[:, :2] / pts3d[:, 2:3] * 320.0 + np.array([320.0, 240.0])
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:60] += rng.uniform(50, 200, (60, 2)).astype(np.float32)
    K = np.array([[320.0, 0, 320], [0, 320, 240], [0, 0, 1]])
    pri = torch.rand((512, n), generator=torch.Generator().manual_seed(4))
    a = pnp.solve_pnp_ransac(uv, pts3d, K, n_hypotheses=512, priorities=pri,
                             device="cpu")
    b = pnp.solve_pnp_ransac(uv, pts3d, K, n_hypotheses=512, priorities=pri,
                             device=cuda)
    assert a["success"] and b["success"]
    assert a["num_inliers"] == b["num_inliers"]
    np.testing.assert_array_equal(a["inliers"], b["inliers"])
    assert np.abs(a["r"] - b["r"]).max() <= 1e-4
    assert np.abs(a["t"] - b["t"]).max() <= 1e-4


def test_refine_level_on_card_matches_cpu(cuda):
    """One refinement level (forward walk, backward walk and reduction per
    iteration) on the card against the CPU path's plain versions: the same
    iteration count, xi within 1e-4, the start loss within 1e-5 relative
    and the best loss within 1e-3 (it is taken at poses up to 1e-4 apart);
    the three kernels launch on the card."""
    from splatloc_tpu_torch.core import transforms
    from splatloc_tpu_torch.match import localize
    out = {}
    for dev in ("cpu", cuda):
        means, scales, quats, opac, colors = make_scene(11, dense=True)
        n = means.shape[0]
        sc = GaussianScene(
            xyz=means.to(dev), f_dc=((colors[:, None, :3] - 0.5)
                                     / 0.28209479177387814).to(dev),
            f_rest=torch.zeros((n, 0, 3), device=dev),
            scaling=torch.log(scales).to(dev), rotation=quats.to(dev),
            opacity=torch.logit(opac)[:, None].to(dev),
            marker=torch.zeros((n, 1), device=dev),
            kp_score=colors[:, 3:].to(dev),
            alive=torch.ones((n,), dtype=torch.bool, device=dev))
        cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                            H / 2, W, H, device=dev)
        with torch.no_grad():
            gt = render(sc, cam, RasterConfig(use_pallas=True))["render"]
        w2c0 = transforms.se3_exp(torch.tensor(
            [0.02, -0.01, 0.01, 0.01, -0.01, 0.005], device=dev))
        before = (hopper_raster.fwd_pairwalk.launches,
                  hopper_raster.bwd_pairwalk.launches,
                  hopper_raster.seg_reduce.launches)
        xi, info = localize._refine_level(sc, cam, w2c0, gt, 8, 2e-3, 1e-4,
                                          8, RasterConfig(use_pallas=True))
        after = (hopper_raster.fwd_pairwalk.launches,
                 hopper_raster.bwd_pairwalk.launches,
                 hopper_raster.seg_reduce.launches)
        out[str(dev)] = (xi.cpu(), info, [b - a for a, b in zip(before,
                                                                 after)])
    (xc, ic, lc), (xg, ig, lg) = out["cpu"], out[str(cuda)]
    assert lc == [0, 0, 0] and lg == [8, 8, 8]
    assert ig["iters"] == ic["iters"] == 8
    assert float((xg - xc).abs().max()) <= 1e-4
    np.testing.assert_allclose(float(ig["loss0"]), float(ic["loss0"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ig["loss"]), float(ic["loss"]),
                               rtol=1e-3)


def test_auction_round_does_not_sync(cuda, monkeypatch):
    """An auction round issues no host sync (no mask index); the whole
    auction reads the unassigned count once per block of 20 rounds."""
    from splatloc_tpu_torch.match import hungarian
    rng = np.random.default_rng(5)
    d2 = rng.normal(size=(64, 300)).astype(np.float32)
    d1 = d2[:, rng.permutation(300)[:200]] + 0.4 * rng.normal(
        size=(64, 200)).astype(np.float32)
    sim = hungarian._sim_matrix(torch.from_numpy(d1).to(cuda),
                                torch.from_numpy(d2).to(cuda), 0.4)
    R, C = sim.shape
    state = (torch.zeros((C,), device=cuda),
             torch.full((C,), -1, dtype=torch.int32, device=cuda),
             torch.full((R,), -1, dtype=torch.int32, device=cuda))
    _, n = count_syncs(lambda: hungarian._auction_round(sim, *state, 1e-4))
    assert n == 0
    rounds = []
    one_round = hungarian._auction_round
    monkeypatch.setattr(hungarian, "_auction_round",
                        lambda *a: rounds.append(1) or one_round(*a))
    got, n = count_syncs(lambda: hungarian.auction_assignment(sim,
                                                              eps=1e-4))
    assert n == -(-len(rounds) // 20)
    assert bool((got >= 0).all())


def test_refine_pose_counts_its_syncs(cuda):
    """refine_pose's info["syncs"] is every host sync it makes."""
    from splatloc_tpu_torch.core import transforms
    from splatloc_tpu_torch.match import localize
    means, scales, quats, opac, colors = make_scene(12, dense=True)
    n = means.shape[0]
    sc = GaussianScene(
        xyz=means.to(cuda), f_dc=((colors[:, None, :3] - 0.5)
                                  / 0.28209479177387814).to(cuda),
        f_rest=torch.zeros((n, 0, 3), device=cuda),
        scaling=torch.log(scales).to(cuda), rotation=quats.to(cuda),
        opacity=torch.logit(opac)[:, None].to(cuda),
        marker=torch.zeros((n, 1), device=cuda),
        kp_score=colors[:, 3:].to(cuda),
        alive=torch.ones((n,), dtype=torch.bool, device=cuda))
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device=cuda)
    with torch.no_grad():
        gt = render(sc, cam, RasterConfig(use_pallas=True))["render"]
    w2c0 = transforms.se3_exp(torch.tensor(
        [0.02, -0.01, 0.01, 0.01, -0.01, 0.005], device=cuda))
    torch.cuda.synchronize()
    (xi, info), n_sync = count_syncs(lambda: localize.refine_pose(
        sc, cam, w2c0, gt, iters=6, levels=(2, 1)))
    assert info["syncs"] == n_sync


def test_tiled_blend_on_card_matches_pair_path(cuda):
    """rasterize with use_pallas=False (the tiled blend) on the card against
    the pair kernels, to the JAX package's pair-vs-blend limits; the blend
    launches no pair kernel."""
    sc = [x.to(cuda) for x in make_scene(13)]
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device=cuda)
    before = hopper_raster.fwd_pairwalk.launches
    blend = rasterize(*sc, cam, RasterConfig(use_pallas=False))
    assert hopper_raster.fwd_pairwalk.launches == before
    pair = rasterize(*sc, cam, RasterConfig(use_pallas=True))
    assert float((blend.image - pair.image).abs().max()) <= 5e-5
    assert float((blend.depth - pair.depth).abs().max()) <= 2e-4
    assert float((blend.alpha - pair.alpha).abs().max()) <= 5e-5


def test_trace_on_card_names_the_kernels(cuda, tmp_path):
    """utils.profiling.trace on the card writes a trace that names the
    forward walk's launches."""
    from splatloc_tpu_torch.utils.profiling import trace
    sc = [x.to(cuda) for x in make_scene(14)]
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device=cuda)
    rasterize(*sc, cam, RasterConfig(use_pallas=True))
    with trace(str(tmp_path), cuda):
        rasterize(*sc, cam, RasterConfig(use_pallas=True))
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    assert "fwd_pairwalk" in files[0].read_text()


def _decoder_case(cuda, seed=0):
    from splatloc_tpu_torch.fields import FeatureFieldConfig, init_decoder
    from splatloc_tpu_torch.fields.hashgrid import HashGridConfig
    cfg = FeatureFieldConfig(
        bound=((-1.0, 1.0), (-1.0, 1.0), (-1.0, 1.0)), num_layers=4,
        hidden_dim=128, final_dim=256,
        grid=HashGridConfig(n_levels=16, log2_hashmap_size=14,
                            desired_resolution=64))
    g = torch.Generator(cuda).manual_seed(seed)
    params = init_decoder(cfg, g, device=cuda)
    params["table"] = params["table"] * 1e3
    x = torch.rand((256, 3), generator=g, device=cuda) * 2 - 1
    f = torch.randn((256, 256), generator=g, device=cuda)
    return cfg, params, x, f


def _train_steps(cfg, params, x, f, n=3):
    from splatloc_tpu_torch.train import decoder_train
    params = {"table": params["table"].clone().requires_grad_(),
              "layers": [w.clone().requires_grad_()
                         for w in params["layers"]]}
    opt = decoder_train.make_optimizer(params)
    losses = [decoder_train.train_step(params, opt, x, f, cfg)
              for _ in range(n)]
    return params, torch.stack(losses)


@pytest.mark.parametrize("tf32", [False, True])
def test_decoder_steps_ignore_tf32_switches(cuda, tf32):
    """Decoder training steps (forward, backward, Adam) give the same bits
    with the caller's TF32 switches on as with them off, and two runs agree
    bit for bit; the switches are the caller's again afterwards."""
    cfg, params, x, f = _decoder_case(cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref, ref_loss = _train_steps(cfg, params, x, f)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        got, loss = _train_steps(cfg, params, x, f)
        assert torch.backends.cuda.matmul.allow_tf32 is tf32
        assert torch.backends.cudnn.allow_tf32 is tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = True
    assert torch.equal(loss, ref_loss)
    assert torch.equal(got["table"], ref["table"])
    for a, b in zip(got["layers"], ref["layers"]):
        assert torch.equal(a, b)


def test_decoder_step_makes_no_host_sync(cuda):
    """A training step queues its work without waiting for the device."""
    from splatloc_tpu_torch.train import decoder_train
    cfg, params, x, f = _decoder_case(cuda, seed=1)
    for p in [params["table"], *params["layers"]]:
        p.requires_grad_(True)
    opt = decoder_train.make_optimizer(params)
    decoder_train.train_step(params, opt, x, f, cfg)
    _, n = count_syncs(lambda: decoder_train.train_step(params, opt, x, f,
                                                        cfg))
    assert n == 0


def test_netvlad_ignores_tf32_switches(cuda):
    """NetVLAD's convolutions and whitening run in full float32 whatever
    the caller's switches, and agree with the CPU path within 1e-5."""
    from splatloc_tpu_torch.match import netvlad
    params = netvlad.init_params(torch.Generator(cuda).manual_seed(0),
                                 whiten_dim=256, device=cuda)
    img = torch.rand((96, 128, 3), generator=torch.Generator(
        cuda).manual_seed(1), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = netvlad.global_descriptor(params, img)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        got = netvlad.global_descriptor(params, img)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, ref)
    cpu = netvlad.global_descriptor({k: v.cpu() for k, v in params.items()},
                                    img.cpu())
    assert float((ref.cpu() - cpu).abs().max()) <= 1e-5


def test_fusion_on_card_matches_cpu(cuda):
    """integrate_frame and fuse_point_features on the card against the CPU
    path: weights and colours equal but for voxels at a pixel boundary
    (at most 1e-4 of them), tsdf within 1e-5, fused features within
    1e-5."""
    from splatloc_tpu_torch.fields import fusion
    rng = np.random.default_rng(3)
    depth = (2.0 + 0.5 * rng.uniform(size=(48, 64))).astype(np.float32)
    rgb = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.05, -0.02, 0.1]
    bound = np.array([[-1.5, 1.5], [-1.2, 1.2], [0.5, 3.5]], np.float32)
    vols = [fusion.integrate_frame(
        fusion.TSDFVolume.create(bound, 0.05, device=d), depth, rgb, K, c2w)
        for d in (cuda, "cpu")]
    g, c = vols
    flipped = ((g.weight.cpu() != c.weight)
               | (g.color.cpu() != c.color).any(-1))
    assert float(flipped.float().mean()) <= 1e-4
    assert float((g.tsdf.cpu() - c.tsdf)[~flipped].abs().max()) <= 1e-5
    pts, _ = fusion.extract_surface_points(c)
    feat = rng.normal(size=(48, 64, 8)).astype(np.float32)
    fg, wg = fusion.fuse_point_features(pts, [(feat, depth, c2w)], K, 8,
                                        device=cuda)
    fc, wc = fusion.fuse_point_features(pts, [(feat, depth, c2w)], K, 8,
                                        device="cpu")
    assert (wg != wc).mean() <= 1e-3 and wc.any()
    same = wg == wc
    assert np.abs(fg[same] - fc[same]).max() <= 1e-5


def test_encode_backward_on_card_keeps_the_gather_bits(cuda, monkeypatch):
    """hashgrid's table gather keeps, on the card, the bits of the plain
    index's backward (index_put_ with accumulate, which sorts first)."""
    from splatloc_tpu_torch.fields import hashgrid
    cfg = hashgrid.HashGridConfig(desired_resolution=133)
    g = torch.Generator(device=cuda).manual_seed(5)
    table = torch.rand((16, cfg.table_size, 2), generator=g, device=cuda)
    pos = torch.rand((4096, 3), generator=g, device=cuda)
    ct = torch.randn((4096, cfg.out_dim), generator=g, device=cuda)

    def table_grad():
        t = table.clone().requires_grad_()
        (hashgrid.encode(t, pos, cfg) * ct).sum().backward()
        return t.grad

    got = table_grad()
    monkeypatch.setattr(hashgrid._TableGather, "apply",
                        lambda flat, idx: flat[idx])
    assert torch.equal(got, table_grad())


def test_sharded_render_of_one_rank_on_card(cuda):
    """rasterize_sharded on a mesh of one rank (no process group) runs the
    three kernels once each, forward and backward, and gives rasterize's
    image bit for bit and its gradients."""
    from splatloc_tpu_torch.dist import global_mesh, rasterize_sharded
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                        H / 2, W, H, device=cuda)
    cfg = RasterConfig(use_pallas=True)
    res = {}
    for name, fn in (("single", lambda *a: rasterize(*a, cam, cfg)),
                     ("sharded", lambda *a: rasterize_sharded(
                         *a, cam, cfg, global_mesh(tile=1)))):
        sc = [x.to(cuda).requires_grad_(True) for x in make_scene(9)]
        kernels = (hopper_raster.fwd_pairwalk, hopper_raster.bwd_pairwalk,
                   hopper_raster.seg_reduce)
        before = [k.launches for k in kernels]
        out = fn(*sc)
        loss = (out.image ** 2).mean() + 0.05 * out.depth.mean()
        grads = torch.autograd.grad(loss, sc)
        assert [k.launches - b for k, b in zip(kernels, before)] == [1, 1, 1]
        res[name] = (out.image, out.depth, grads)
    assert torch.equal(res["sharded"][0], res["single"][0])
    assert torch.equal(res["sharded"][1], res["single"][1])
    for a, b in zip(res["sharded"][2], res["single"][2]):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_eval_rehearsal_on_card_small(cuda):
    """The rehearsal tool at 64x48 on the card (2 queries, one refinement):
    finite stage medians, every query at PnP, and each kernel launched
    exactly as its records imply (a forward a database render, the
    target, each seed, iteration and guard render; a backward and a
    reduction an iteration)."""
    from splatloc_tpu_torch.tools import eval_rehearsal

    kernels = (hopper_raster.fwd_pairwalk, hopper_raster.bwd_pairwalk,
               hopper_raster.seg_reduce)
    for k in kernels:
        k.launches = 0
    run = eval_rehearsal.run(
        n_queries=2, device=cuda, W=64, H=48, fx=32.0, n_gauss=2000,
        capacity=2048, n_train=8, n_key=600, n_landmarks=50, mask_px=600,
        max_points=256, max_keypoints=128, n_refine=1, refine_iters=4)
    torch.cuda.synchronize()
    info = run.refinements[0]["info"]
    iters = sum(lv["iters"] for lv in info["levels"])
    assert [k.launches for k in kernels] == [
        8 + 1 + info["seed_evals"] + iters + 2, iters, iters]
    res = run.result
    assert res["finite"] and len(run.stages["pnp"]) == 2
    assert all(v is not None for k, v in res.items() if k.startswith("ms_"))
    assert run.pnp_errors == [] and len(run.landmarks) == 50


_SMALL_TOOL_RUNS = {
    "quality_gate": "n_frames=4, n_eval=2, map_iters=8, n_gauss_gt=2000, "
                    "W=64, H=48, capacity=8192",
    "eval_rehearsal": "n_queries=1, W=64, H=48, fx=32.0, n_gauss=2000, "
                      "capacity=2048, n_train=8, n_key=600, n_landmarks=50, "
                      "mask_px=600, max_points=256, max_keypoints=128, "
                      "n_refine=1, refine_iters=4",
}


@pytest.mark.parametrize("tool", sorted(_SMALL_TOOL_RUNS))
def test_tool_runs_on_an_indexed_device_in_a_fresh_process(cuda, tool,
                                                          tmp_path):
    """Each reference-scale tool at a small size on ``cuda:0`` in a
    process that has not touched the card yet: the peak-memory reset comes
    after the tool's first allocation (before it, the reset raises on a
    device named by index) and the run reports a peak."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    code = (f"from splatloc_tpu_torch.tools import {tool}\n"
            f"r = {tool}.run(device='cuda:0', {_SMALL_TOOL_RUNS[tool]})\n"
            "assert r.peak_mem_gb > 0, r.peak_mem_gb\n")
    env = {**os.environ, "PYTHONPATH": str(root),
           "SPLATLOC_GATE_LOG": str(tmp_path / "progress.jsonl"),
           "SPLATLOC_GATE_CKPT": str(tmp_path / "ckpt.npz")}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]


# each benchmark or profiling tool's main at a small size, and the keys of
# the JAX program's result line in their order
_BENCH_TOOL_RUNS = {
    "bench": ("device='cuda:0', iters=3, stages=(('small', 48, 64, 2000, "
              "True, True),)", ("metric", "value", "unit", "vs_baseline")),
    "bench_pose": ("device='cuda:0', iters=3, H=48, W=64, N=2000",
                   ("metric", "value", "unit", "vs_baseline")),
    "bench_refine": ("1, N=20000, W=48, H=32, device='cuda:0'",
                     ("metric", "median_t_cm", "median_r_deg", "start_t_cm",
                      "start_r_deg", "t_reduction_x", "r_reduction_x",
                      "iters_per_s", "n_seeds")),
    "profile_bench": ("2, device='cuda:0', H=48, W=64, N=2000",
                      ("tool", "ms_per_iter", "mpix_s", "device_op_ms",
                       "device_idle_ms")),
    "profile_chain": ("2, device='cuda:0', H=48, W=64, N=2000",
                      ("tool", "ms_per_iter", "mpix_s", "device_busy_ms",
                       "device_idle_ms")),
    "profile_map": ("20000, 2, device='cuda:0', W=64, H=48, fx=32.0",
                    ("tool", "ms_per_step", "it_s", "n_alive", "capacity",
                     "device_op_ms")),
}


@pytest.mark.parametrize("tool", sorted(_BENCH_TOOL_RUNS))
def test_bench_tool_prints_one_line_on_card(cuda, tool):
    """Each benchmark and profiling tool at a small size on ``cuda:0`` in a
    fresh process: exactly one JSON line on stdout, with the JAX
    program's keys in their order and finite numbers (the profile tools'
    device times measured, not None)."""
    import json
    import math
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    call, keys = _BENCH_TOOL_RUNS[tool]
    code = (f"from splatloc_tpu_torch.tools import {tool}\n"
            f"{tool}.main({call})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          env={**os.environ, "PYTHONPATH": str(root)},
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    line = json.loads(lines[0])
    assert tuple(line) == keys
    for k, v in line.items():
        if tool == "bench_pose" and k == "vs_baseline":
            assert v is None                # the JAX program's null
        elif not isinstance(v, str):
            assert v is not None and math.isfinite(v), (k, line)


def _fit_problem(dev, seed=0, n=900, n_hyp=1024):
    """Pairs shaped like the localize cell's (~900, a third of them outliers
    at random places, 1 px of noise at f = 320) and their 1,024 DLT
    hypotheses, on ``dev``."""
    from splatloc_tpu_torch.match import pnp
    rng = np.random.default_rng(seed)
    pts3d = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      rng.uniform(1, 6, n)], -1).astype(np.float32)
    uv = pts3d[:, :2] / pts3d[:, 2:3] + rng.normal(0, 1 / 320, (n, 2))
    uv[:n // 3] = rng.uniform(-1, 1, (n // 3, 2))
    p2 = torch.from_numpy(uv.astype(np.float32)).to(dev)
    p3 = torch.from_numpy(pts3d).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    pri = torch.rand((n_hyp, n), generator=torch.Generator().manual_seed(seed))
    R, t, ok = pnp._hypotheses(p2, p3, valid, pri.to(dev), 6)
    return R, t, p2, p3, valid, ok, float(np.float32(12.0 / 320))


def _both_fits(fit, R, t, p2, p3, valid, ok, thr):
    from splatloc_tpu_torch.core.precision import full_float32
    with full_float32():
        Rh, th, score = fit(R, t, p2, p3, valid, thr, 5, ok=ok)
        best = torch.argmax(score)
        Rf, tf, inl, n = fit(Rh, th, p2, p3, valid, thr, 10, best=best)
    return score, best, Rf, tf, inl, n


def test_gauss_newton_fit_kernel_matches_plain(cuda):
    """The kernel's two fits against the plain version's on the card, on
    cell-shaped pairs: the same score on every contender (a hypothesis
    within 90 % of the best count on either side; the fits of the others
    are ill-posed, and rounding moves them), the same winning hypothesis
    and final inliers, R and t within 1e-5."""
    from splatloc_tpu_torch.match import pnp
    args = _fit_problem(cuda)
    ks, kb, kR, kt, ki, kn = _both_fits(pnp.gauss_newton_fit, *args)
    ps, pb, pR, pt, pi, pn = _both_fits(pnp.gauss_newton_fit_plain, *args)
    assert int(ks.max()) == int(ps.max()) > 500
    top = (ks >= 0.9 * ks.max()) | (ps >= 0.9 * ps.max())
    assert int(top.sum()) >= 10
    assert torch.equal(ks[top], ps[top]), (ks[top], ps[top])
    assert int(kb) == int(pb)
    assert torch.equal(ki, pi) and int(kn) == int(pn)
    assert float((kR - pR).abs().max()) <= 1e-5
    assert float((kt - pt).abs().max()) <= 1e-5


def test_gauss_newton_fit_kernel_is_deterministic(cuda):
    """Two runs of the kernel's fits agree bit for bit, and a failed DLT
    (non-finite pose, ok False) scores -1."""
    from splatloc_tpu_torch.match import pnp
    R, t, p2, p3, valid, ok, thr = _fit_problem(cuda, seed=1)
    R[3], t[3], ok[3] = float("nan"), float("nan"), False
    a = _both_fits(pnp.gauss_newton_fit, R, t, p2, p3, valid, ok, thr)
    b = _both_fits(pnp.gauss_newton_fit, R, t, p2, p3, valid, ok, thr)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert int(a[0][3]) == -1


def test_solve_pnp_ransac_on_card_launches_the_fit_twice(cuda):
    """A solve on the card launches the fit kernel twice and gives the
    result of the plain fits within 1e-5 with the same inliers."""
    from unittest import mock
    from splatloc_tpu_torch.match import pnp
    R, t, p2, p3, valid, ok, thr = _fit_problem(cuda, seed=2, n=400)
    uv = (p2.cpu().numpy() * 320 + np.array([320, 240])).astype(np.float32)
    K = np.array([[320.0, 0, 320], [0, 320, 240], [0, 0, 1]])
    n0 = pnp.gauss_newton_fit.launches
    a = pnp.solve_pnp_ransac(uv, p3.cpu().numpy(), K, device=cuda)
    assert pnp.gauss_newton_fit.launches - n0 == 2
    with mock.patch.object(pnp, "gauss_newton_fit",
                           pnp.gauss_newton_fit_plain):
        b = pnp.solve_pnp_ransac(uv, p3.cpu().numpy(), K, device=cuda)
    assert a["success"] and b["success"]
    assert a["num_inliers"] == b["num_inliers"]
    np.testing.assert_array_equal(a["inliers"], b["inliers"])
    assert np.abs(a["r"] - b["r"]).max() <= 1e-5
    assert np.abs(a["t"] - b["t"]).max() <= 1e-5
