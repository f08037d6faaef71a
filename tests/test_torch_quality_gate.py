"""Opt-in full-scale quality gate of the PyTorch port, on the card.

The counterpart of tests/test_quality_gate.py: the port's gate
(``splatloc_tpu_torch.tools.quality_gate``) at the reference's scale —
640x480, 36 keyframes, 2,200 mapping iterations through densify/prune and
the opacity reset, >= 100k Gaussians — held to the same five bars, and the
mapping steps' kernel launches counted. Slow (many minutes) and meant for
an NVIDIA GPU, so it runs only when asked for and a card is present:

    SPLATLOC_QUALITY_GATE=1 python -m pytest tests/test_torch_quality_gate.py \
        --noconftest -s

It imports no JAX (``--noconftest``: the suite's conftest does). Progress
rows and the checkpoint go to a temp dir, so the gate always maps.
"""
import os

import pytest
import torch

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif(
        not os.environ.get("SPLATLOC_QUALITY_GATE"),
        reason="full-scale gate: set SPLATLOC_QUALITY_GATE=1 (slow; "
               "GPU-scale)"),
    pytest.mark.skipif(not torch.cuda.is_available(),
                       reason="needs a CUDA device: the gate maps on the "
                              "card"),
]


def test_full_scale_reconstruction_quality(tmp_path, monkeypatch):
    from splatloc_tpu_torch.raster import hopper_raster
    from splatloc_tpu_torch.tools import quality_gate

    monkeypatch.setenv("SPLATLOC_GATE_LOG", str(tmp_path / "progress.jsonl"))
    monkeypatch.setenv("SPLATLOC_GATE_CKPT", str(tmp_path / "ckpt.npz"))
    kernels = (hopper_raster.fwd_pairwalk, hopper_raster.bwd_pairwalk,
               hopper_raster.seg_reduce)
    for k in kernels:
        k.launches = 0
    res = quality_gate.main()
    fwd, bwd, seg = (k.launches for k in kernels)

    # five windowed views a mapping step; one forward a held-out view (the
    # ground-truth frames are the tiled blend, which launches nothing)
    steps = 5 * res["iters"]
    assert (fwd, bwd, seg) == (steps + 4, steps, steps), (fwd, bwd, seg)
    assert not res["resumed"] and res["iters"] == 2200, res
    assert res["psnr"] >= 30.0, res
    assert res["ssim"] >= 0.85, res
    assert res["kp_contrast"] >= 5.0, res
    assert res["n_alive"] >= 100_000, res
    assert res["n_dropped_total"] == 0, res
