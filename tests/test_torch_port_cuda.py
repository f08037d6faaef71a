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
from splatloc_tpu_torch.raster import RasterConfig, render
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
