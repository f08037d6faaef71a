"""kernel_ab.py's host side on the CPU: every ablation's text edits still
match the kernel sources exactly once (a build that silently stopped
undoing its step would report a wrong cost), and the long/short split of
the tiles keeps every pair of a tile in exactly one half."""
import numpy as np
import pytest
import torch

import kernel_ab
from splatloc_tpu_torch import build
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import RasterConfig, binning, hopper_raster
from splatloc_tpu_torch.raster import project


@pytest.mark.parametrize("name", sorted(kernel_ab.ABLATIONS))
def test_ablation_edits_match_the_sources_once(name):
    edits = kernel_ab.ABLATIONS[name]
    assert edits
    for f, old, new in edits:
        assert f in kernel_ab.FILES
        assert (build.CSRC / f).read_text().count(old) == 1, (f, old)
        assert old != new


def test_builds_compile_what_they_hold_or_edit(tmp_path, monkeypatch):
    """A reference directory compiles the kernels whose sources it holds
    (an earlier commit's seg_reduce.cu alone: the reduction only); an
    ablation compiles the kernels its edits touch (the walks share
    pair_power.cuh)."""
    monkeypatch.setattr(kernel_ab, "AB_DIR", tmp_path / "ab")
    old = tmp_path / "old"
    old.mkdir()
    (old / "seg_reduce.cu").write_text("// an earlier reduction\n")
    assert kernel_ab.kernels_of(kernel_ab.make_sources("old", old, [])) \
        == ["seg"]
    full = kernel_ab.make_sources("new", build.CSRC, [])
    assert kernel_ab.kernels_of(full) == ["fwd", "bwd", "seg"]
    for name, edits in kernel_ab.ABLATIONS.items():
        want = ["seg"] if name.startswith("seg_") else ["fwd", "bwd"]
        assert kernel_ab.kernels_of(None, edits) == want, name


def test_split_inputs_partitions_the_tiles():
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    n, w, h = 400, 64, 48
    means = torch.from_numpy(np.stack(
        [rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
         rng.uniform(1, 5, n)], -1).astype(np.float32))
    scales = torch.from_numpy(
        np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(np.float32))
    quats = torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32))
    opac = torch.from_numpy(rng.uniform(0.2, 0.97, n).astype(np.float32))
    colors = torch.from_numpy(rng.uniform(0, 1, (n, 4)).astype(np.float32))
    cfg = RasterConfig(use_pallas=True)
    cam = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, w / 2,
                        h / 2, w, h, device="cpu")
    proj = project.project_gaussians(means, scales, quats, cam, cfg,
                                     opacities=opac)
    gpair, pr, origins = hopper_raster._pair_inputs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c), opac,
        proj.depth, colors, (proj.radius_x, proj.radius_y), proj.visible,
        binning.depth_sort(proj), w, h, cfg)
    walk = (gpair, pr["starts"], pr["counts"], origins)
    out = hopper_raster.fwd_pairwalk_plain(*walk, 4, cfg)
    jhi = hopper_raster._jhi(out, pr["starts"], pr["counts"], 4)
    cot = torch.zeros((out.shape[0], 6, out.shape[2]))
    bargs = walk + (jhi, out, cot)
    parts = kernel_ab.split_inputs(walk, bargs)
    long, short = parts["long"], parts["short"]
    counts = pr["counts"]
    assert long[2] + short[2] == int(counts.sum())
    assert torch.equal(long[0][2] + short[0][2], counts)
    kept = long[0][2] > 0
    assert int(kept.sum()) <= max(1, counts.numel() // 10)
    assert int(long[0][2].min()) >= 0
    # a kept tile's jhi is unchanged; the other half's is -1
    for name, (fa, ba, _) in parts.items():
        on = fa[2] > 0
        assert torch.equal(ba[4][on], jhi[on])
        assert bool((ba[4][~on & (counts > 0)] == -1).all())
    # the long half holds the tiles with the most pairs
    if bool(kept.any()) and bool((~kept & (counts > 0)).any()):
        assert int(counts[kept].min()) >= int(counts[~kept].max())


def test_long_run_view_holds_one_run_past_the_bucket():
    """The synthetic long-run input: the sizes and dtype of the input it is
    made like, rank 0 emits the asked run, every rank's emitted pairs lie
    in pair_idx once each, the rest is filler; the plain reduction sums
    every rank with pairs."""
    torch.set_num_threads(1)
    K, PC = 300, 6000
    like = (torch.zeros((PC, 16), dtype=torch.bfloat16),
            torch.zeros(PC, dtype=torch.int32),
            torch.zeros(K, dtype=torch.int32))
    (slab, ids, prc), kmax = kernel_ab.long_run_view(4100, like, 0)
    assert slab.shape == (PC, 16) and slab.dtype == torch.bfloat16
    assert ids.dtype == prc.dtype == torch.int32 and prc.shape == (K,)
    assert kmax == int(prc[0]) == 4100 and int(prc[1:].max()) <= 3
    assert torch.equal(torch.bincount(ids.long(), minlength=K + 1)[:K],
                       prc.long())
    assert int((ids == K).sum()) == PC - int(prc.sum())
    red = hopper_raster.seg_reduce_plain(slab, ids, prc, kmax)
    assert torch.equal((red != 0).any(dim=1), prc > 0)
