"""Four repairs of the port, each with a test that failed before it:

- the auction's round indexes nothing with a boolean mask (a mask index is
  a ``nonzero``, which copies a count to the host every round on the card);
- no port function leaves the process's TF32 switches changed;
- refine_pose counts every host read it makes (``info["syncs"]``);
- the hash grid's backward gives the same bits on a CPU with several
  threads.

And refine_pose's raster path by device."""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.match import hungarian, localize
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene.gaussians import GaussianScene

torch.set_num_threads(1)


class _MaskIndexWatch(TorchDispatchMode):
    """Records every op that indexes with a boolean mask or selects by
    one (the ops that need a nonzero), and every index assignment: each
    makes a host sync on the card (torch.cuda.set_sync_debug_mode shows
    them)."""

    MASK_OPS = ("aten.nonzero", "aten.masked_select", "aten.masked_scatter",
                "aten.index_put", "aten._index_put_impl")
    INDEX_OPS = ("aten.index.",)

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(self.MASK_OPS):
            self.found.append(name)
        elif name.startswith(self.INDEX_OPS):
            idx = args[1] if len(args) > 1 else []
            if any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8) for i in idx):
                self.found.append(name)
        return func(*args, **(kwargs or {}))


def _sim(seed=0, rows=60, cols=90):
    rng = np.random.default_rng(seed)
    d2 = rng.normal(size=(32, cols)).astype(np.float32)
    d1 = d2[:, rng.permutation(cols)[:rows]] + 0.3 * rng.normal(
        size=(32, rows)).astype(np.float32)
    return hungarian._sim_matrix(torch.from_numpy(d1), torch.from_numpy(d2),
                                 0.4)


def test_mask_watch_sees_a_mask_index():
    """The watch flags the old round's winner assignment, and its
    eviction and second-maximum index assignments."""
    x = torch.zeros(5, dtype=torch.int32)
    won = torch.tensor([True, False, True, False, False])
    with _MaskIndexWatch() as w:
        x[torch.arange(5)[won]] = 1
    assert w.found
    with _MaskIndexWatch() as w:
        x[torch.tensor([0, -1])] = 1
    assert w.found


def test_auction_round_has_no_mask_index():
    """Every round of an auction to convergence runs without a boolean
    mask index or an index assignment, and the rounds assign what the JAX
    package's spare-slot writes assign (the same-assignment checks are in
    test_torch_port_match.py)."""
    # a random matrix: rows compete for columns for many rounds
    sim = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (60, 70)).astype(np.float32))
    R, C = sim.shape
    prices = torch.zeros((C,))
    owner = torch.full((C,), -1, dtype=torch.int32)
    col = torch.full((R,), -1, dtype=torch.int32)
    rounds = 0
    with _MaskIndexWatch() as w:
        while rounds < 2000:
            prices, owner, col = hungarian._auction_round(sim, prices,
                                                          owner, col, 1e-4)
            rounds += 1
            if not (col < 0).any():
                break
    assert not w.found, w.found
    assert rounds > 20 and (col >= 0).all()
    # a column's owner and a row's column agree
    np.testing.assert_array_equal(owner.numpy()[col.numpy()], np.arange(R))
    np.testing.assert_array_equal(
        col.numpy(), hungarian.auction_assignment(sim, eps=1e-4).numpy())


def _tiny_gaussians(seed, n=40):
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-0.7, 0.7, n),
                    rng.uniform(2, 4, n)], -1).astype(np.float32)
    col = rng.uniform(0.1, 0.9, (n, 3)).astype(np.float32)
    return GaussianScene(
        xyz=torch.from_numpy(xyz),
        f_dc=torch.from_numpy((col - 0.5) / 0.28209479177387814)[:, None],
        f_rest=torch.zeros((n, 0, 3)),
        scaling=torch.full((n, 3), float(np.log(0.12))),
        rotation=torch.tensor([[1.0, 0, 0, 0]]).repeat(n, 1),
        opacity=torch.full((n, 1), 1.5), marker=torch.zeros((n, 1)),
        kp_score=torch.zeros((n, 1)),
        alive=torch.ones((n,), dtype=torch.bool), sh_degree=0)


def _call_each(name):
    """Call one of the eight functions that scope full float32 on small
    CPU inputs (an autograd backward for the SSIM filter)."""
    rng = np.random.default_rng(1)
    if name == "decode":
        from splatloc_tpu_torch.fields import (FeatureFieldConfig, decode,
                                               init_decoder)
        cfg = FeatureFieldConfig(num_layers=2, hidden_dim=8, final_dim=8)
        p = init_decoder(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
        decode(p, torch.rand((5, 3)) * 2 - 1, cfg)
    elif name == "sim_matrix":
        _sim(rows=8, cols=10)
    elif name == "nearest_neighbor":
        from splatloc_tpu_torch.match import frustum
        frustum.nearest_neighbor(torch.rand((4, 3)), torch.rand((9, 3)),
                                 torch.ones((9,), dtype=torch.bool))
    elif name == "pnp":
        from splatloc_tpu_torch.match import pnp
        pts3d = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20),
                          rng.uniform(2, 4, 20)], -1).astype(np.float32)
        uv = (pts3d[:, :2] / pts3d[:, 2:] * 50 + 32).astype(np.float32)
        K = np.array([[50.0, 0, 32], [0, 50.0, 32], [0, 0, 1]])
        pnp.solve_pnp_ransac(uv, pts3d, K, n_hypotheses=8, device="cpu")
    elif name == "saliency":
        from splatloc_tpu_torch.eval import selection
        w2cs = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
        selection.saliency_scores(
            rng.uniform(-1, 1, (6, 3)).astype(np.float32) + [0, 0, 3], w2cs,
            np.array([[20.0, 0, 8], [0, 20.0, 8], [0, 0, 1]]),
            np.full((2, 16, 16), 3.0, np.float32), device="cpu")
    elif name == "superpoint":
        from splatloc_tpu_torch.match import superpoint
        p = superpoint.init_params(torch.Generator().manual_seed(0),
                                   device="cpu")
        superpoint.dense_outputs(p, torch.rand((16, 16)))
    elif name == "lpips":
        from splatloc_tpu_torch.eval import metrics
        p = {}
        cin = 3
        for i, (cout, k, _, _) in enumerate(metrics._ALEX_CFG):
            p[f"conv{i}_w"] = torch.randn((cout, cin, k, k)) * 0.01
            p[f"conv{i}_b"] = torch.zeros((cout,))
            p[f"lin{i}"] = torch.ones((cout,))
            cin = cout
        metrics.lpips_fn(p)(torch.rand((64, 64, 3)), torch.rand((64, 64, 3)))
    elif name == "ssim":
        from splatloc_tpu_torch.train.losses import ssim
        a = torch.rand((16, 16, 3), requires_grad=True)
        ssim(a, torch.rand((16, 16, 3))).backward()
    else:
        raise KeyError(name)


TF32_SITES = ["decode", "sim_matrix", "nearest_neighbor", "pnp", "saliency",
              "superpoint", "lpips", "ssim"]


@pytest.mark.parametrize("name", TF32_SITES)
def test_tf32_switches_survive(name, monkeypatch):
    """With both TF32 switches set by the caller, each function leaves them
    set (before, each switched one off for the whole process)."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    _call_each(name)
    assert torch.backends.cuda.matmul.allow_tf32 is True
    assert torch.backends.cudnn.allow_tf32 is True


def test_full_float32_scopes_and_restores(monkeypatch):
    """Inside the block both switches are off; after it (an exception
    included) they are as the caller left them."""
    for m, c in ((True, False), (False, True)):
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", m)
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", c)
        with pytest.raises(ZeroDivisionError):
            with full_float32():
                assert not torch.backends.cuda.matmul.allow_tf32
                assert not torch.backends.cudnn.allow_tf32
                1 / 0
        assert torch.backends.cuda.matmul.allow_tf32 is m
        assert torch.backends.cudnn.allow_tf32 is c


def test_ssim_backward_matches_autograd_conv():
    """The SSIM filter's hand-written backward (a transposed conv in full
    float32) gives autograd's gradient of the plain conv."""
    import torch.nn.functional as F
    from splatloc_tpu_torch.train import losses
    x = torch.rand((1, 3, 20, 24), dtype=torch.float64, requires_grad=True)
    w = losses._gaussian_window(11).double()[None, None].expand(3, 1, 11, 11)
    g = torch.rand((1, 3, 20, 24), dtype=torch.float64)
    (a,) = torch.autograd.grad(losses._WindowFilter.apply(x, w), x, g)
    (b,) = torch.autograd.grad(F.conv2d(x, w, padding=5, groups=3), x, g)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def _refine_setup():
    scene = _tiny_gaussians(4)
    cam = Camera.create(np.eye(4, dtype=np.float32), 40.0, 40.0, 31.5, 23.5,
                        64, 48, device="cpu")
    with torch.no_grad():
        from splatloc_tpu_torch.raster import render
        gt = render(scene, cam, RasterConfig())["render"]
    from splatloc_tpu_torch.core import transforms
    w2c0 = transforms.se3_exp(torch.tensor([0.02, -0.01, 0.01, 0.01, -0.01,
                                            0.005]))
    return scene, cam, gt, w2c0


def test_refine_pose_sync_count():
    """With patience past the iteration cap every level runs ``iters``
    iterations and reads its stop test once per iteration; the seed losses,
    every level's losses together and the guard are one read each:
    syncs = 1 + levels * iters + 1 + 1. Before, the two per-level loss
    reads (and the guard's second) were not counted."""
    scene, cam, gt, w2c0 = _refine_setup()
    iters = 3
    xi, info = localize.refine_pose(scene, cam, w2c0, gt, iters=iters,
                                    patience=100, levels=(2, 1))
    assert [r["iters"] for r in info["levels"]] == [iters, iters]
    assert info["seed_evals"] == 17
    assert info["syncs"] == 1 + 2 * iters + 1 + 1
    for r in info["levels"]:
        assert isinstance(r["loss0"], float) and isinstance(r["loss"], float)
        assert r["loss"] <= r["loss0"]
    # without seeds, one read fewer; a host array's upload is one more
    _, info = localize.refine_pose(scene, cam, w2c0, gt, iters=iters,
                                   patience=100, levels=(2, 1),
                                   multi_start_deg=())
    assert info["syncs"] == 2 * iters + 1 + 1
    _, info = localize.refine_pose(scene, cam, w2c0.numpy(), gt,
                                   iters=iters, patience=100, levels=(2, 1),
                                   multi_start_deg=())
    assert info["syncs"] == 1 + 2 * iters + 1 + 1


def test_refine_pose_default_path_by_device():
    """On the CPU, refine_pose's default is the tiled blend (the JAX
    package's rule): the same pose and losses as with the blend passed
    explicitly."""
    scene, cam, gt, w2c0 = _refine_setup()
    kw = dict(iters=2, levels=(1,), multi_start_deg=())
    xa, ia = localize.refine_pose(scene, cam, w2c0, gt, **kw)
    xb, ib = localize.refine_pose(scene, cam, w2c0, gt,
                                  raster_cfg=RasterConfig(use_pallas=False),
                                  **kw)
    assert torch.equal(xa, xb)
    assert ia["levels"] == ib["levels"]


def _encode_table_grad(table_np, pos, ct, cfg):
    from splatloc_tpu_torch.fields import hashgrid
    t = torch.from_numpy(table_np).requires_grad_()
    (hashgrid.encode(t, pos, cfg) * ct).sum().backward()
    return t.grad


def test_encode_backward_is_deterministic_on_threads():
    """Two backward passes of hashgrid.encode at 4 threads give the same
    bits (index_put_'s accumulate added duplicate corners in thread order
    there), equal to the one-thread gradient, and within
    test_encode_table_gradient_matches_jax's limit of the per-level form's
    gradient."""
    from splatloc_tpu_torch.fields import hashgrid
    cfg = hashgrid.HashGridConfig(desired_resolution=133)
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, (16, cfg.table_size, 2)).astype(np.float32)
    pos = torch.from_numpy(rng.uniform(0, 1, (4096, 3)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=(4096, cfg.out_dim))
                          .astype(np.float32))
    n_threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        a = _encode_table_grad(table, pos, ct, cfg)
        b = _encode_table_grad(table, pos, ct, cfg)
    finally:
        torch.set_num_threads(n_threads)
    assert torch.equal(a, b)
    assert torch.equal(a, _encode_table_grad(table, pos, ct, cfg))
    t = torch.from_numpy(table).requires_grad_()
    (hashgrid.encode_per_level(t, pos, cfg) * ct).sum().backward()
    np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=1e-5,
                               atol=1e-6)
