"""The port's reference-scale tools against the JAX package's: the quality
gate (``splatloc_tpu_torch.tools.quality_gate`` vs ``tools/quality_gate.py``)
and the refinement table (``splatloc_tpu_torch.tools.refine_table`` vs
``tools/refine_table.py``), at a small size on the CPU.

Both gates write their progress rows and checkpoints under ``tmp_path``
(``SPLATLOC_GATE_LOG``, ``SPLATLOC_GATE_CKPT``): run with its defaults, the
JAX tool appends to the repo's ``GATE_PROGRESS.jsonl``.
"""
import json
import math
import os
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import quality_gate as jgate  # noqa: E402
import refine_table as jtable  # noqa: E402

from splatloc_tpu.core.camera import Camera as JCamera  # noqa: E402
from splatloc_tpu_torch.core.camera import Camera  # noqa: E402
from splatloc_tpu_torch.tools import quality_gate as tgate  # noqa: E402
from splatloc_tpu_torch.tools import refine_table as ttable  # noqa: E402

# the gate's size here: 4 keyframes and 2 eval views at 64x48, 2,000 GT
# Gaussians, 8 mapping iterations (2 a keyframe), capacity 8,192
SMALL = dict(n_frames=4, n_eval=2, map_iters=8, n_gauss_gt=2000, W=64, H=48,
             capacity=8192)
KEYS = ("psnr", "ssim", "kp_contrast", "n_alive", "iters", "iters_per_s",
        "n_dropped_total", "wall_s", "resumed")
# score maps: the two packages' projections differ by float32 ulps, so
# np.round of a landmark's pixel coordinate may flip where it lies within
# an ulp of a half pixel. Budget: at most one landmark in 1,000 (and at
# least one) lands a pixel apart; each moves at most its 5x5 blob
FLIP_SHARE = 1e-3
BLOB_PX = 25


def _unrounded(monkeypatch, module):
    """Make a gate report its means unrounded: both tools round the result
    line with the builtin ``round``, which a module global shadows."""
    monkeypatch.setattr(module, "round", lambda x, ndigits=None: x,
                        raising=False)


def _gate_env(monkeypatch, path: Path):
    monkeypatch.setenv("SPLATLOC_GATE_LOG", str(path / "progress.jsonl"))
    monkeypatch.setenv("SPLATLOC_GATE_CKPT", str(path / "ckpt.npz"))


# --------------------------------------------------------------------------
# numpy builders
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_gauss", [2000, 60_000])
def test_make_gt_scene_is_bit_identical(n_gauss):
    a = jgate.make_gt_scene(n_gauss, np.random.default_rng(3))
    b = tgate.make_gt_scene(n_gauss, np.random.default_rng(3))
    assert len(a) == len(b) == 5
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("n", [4, 36])
def test_orbit_pose_is_bit_identical(n):
    for i in range(n):
        for jitter in ((0.0, 0.0), (0.04, 0.03)):
            a = jgate.orbit_pose(i, n, jitter)
            b = tgate.orbit_pose(i, n, jitter)
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_refine_table_scene_is_bit_identical():
    js = jtable.make_scene(np.random.default_rng(1))
    ts = ttable.make_scene(np.random.default_rng(1), device="cpu")
    for k in ("xyz", "f_dc", "f_rest", "scaling", "rotation", "opacity",
              "marker", "kp_score", "alive"):
        a, b = np.asarray(getattr(js, k)), getattr(ts, k).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def test_pose_err_is_bit_identical():
    rng = np.random.default_rng(2)
    for _ in range(20):
        xi = rng.normal(scale=0.2, size=6).astype(np.float32)
        T = np.asarray(jtable.transforms.se3_exp(jnp.asarray(xi)))
        T_gt = np.asarray(jtable.transforms.se3_exp(jnp.asarray(-xi / 3)))
        assert jtable.pose_err(T, T_gt) == ttable.pose_err(T, T_gt)


# --------------------------------------------------------------------------
# score maps
# --------------------------------------------------------------------------

def _jax_score_map(cam0, landmarks, w2c, W, H):
    """tools/quality_gate.py's score_map (a closure there), line for line."""
    uv, z = cam0.replace_pose(jnp.asarray(w2c)).project(
        jnp.asarray(landmarks))
    uv, z = np.asarray(uv), np.asarray(z)
    sc = np.zeros((H, W), np.float32)
    ui, vi = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(int)
    ok = (z > 0.2) & (ui >= 2) & (ui < W - 2) & (vi >= 2) & (vi < H - 2)
    ui, vi = ui[ok], vi[ok]
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            val = 0.9 * np.exp(-(dx * dx + dy * dy) / 2.0)
            np.maximum.at(sc, (vi + dy, ui + dx), val)
    return sc, np.stack([ui, vi], -1)


def test_score_maps_agree():
    """The gate's keyframe and eval score maps at 64x48 (every landmark of
    the 2,000-Gaussian GT scene): equal, or within the flip budget."""
    W, H, n_frames = 64, 48, 36
    rng = np.random.default_rng(0)
    gt = tgate.make_gt_scene(2000, rng)
    landmarks = gt[0][rng.permutation(2000)[:2500]]
    fx, cx, cy = W / 2.0, (W - 1) / 2, (H - 1) / 2
    jcam = JCamera.create(np.eye(4, dtype=np.float32), fx, fx, cx, cy, W, H)
    tcam = Camera.create(np.eye(4, dtype=np.float32), fx, fx, cx, cy, W, H,
                         device="cpu")
    poses = [tgate.orbit_pose(i, n_frames) for i in range(n_frames)]
    poses += [tgate.orbit_pose(i * (n_frames - 1) // 3, n_frames,
                               jitter=(0.04, 0.03)) for i in range(4)]
    kept = flipped = diff_px = 0
    for w2c in poses:
        ref, px = _jax_score_map(jcam, landmarks, w2c, W, H)
        got = tgate.score_map(tcam, torch.from_numpy(landmarks), w2c)
        assert got.shape == (H, W) and got.dtype == np.float32
        uv, z = tcam.replace_pose(torch.from_numpy(w2c)).project(
            torch.from_numpy(landmarks))
        ours = np.round(uv.numpy()).astype(int)
        ok = ((z.numpy() > 0.2) & (ours[:, 0] >= 2) & (ours[:, 0] < W - 2)
              & (ours[:, 1] >= 2) & (ours[:, 1] < H - 2))
        kept += len(px)
        if ok.sum() == len(px):
            flipped += int((ours[ok] != px).any(-1).sum())
        else:
            flipped += abs(int(ok.sum()) - len(px))
        diff_px += int((got != ref).sum())
    assert kept > 1000
    budget = max(1, math.floor(FLIP_SHARE * kept))
    assert flipped <= budget, (flipped, kept)
    assert diff_px <= BLOB_PX * flipped, (diff_px, flipped)


# --------------------------------------------------------------------------
# the gate: resume from the JAX tool's checkpoint, and a fresh run
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_gate(tmp_path_factory):
    """The JAX tool's run at SMALL, unrounded, with its progress rows and
    checkpoint in a temp dir; GATE_PROGRESS.jsonl's bytes are taken before
    and after."""
    mp = pytest.MonkeyPatch()
    path = tmp_path_factory.mktemp("jax_gate")
    progress = (ROOT / "GATE_PROGRESS.jsonl").read_bytes()
    try:
        _gate_env(mp, path)
        _unrounded(mp, jgate)
        res = jgate.main(**SMALL)
    finally:
        mp.undo()
    assert (ROOT / "GATE_PROGRESS.jsonl").read_bytes() == progress
    return path, res


def test_gate_resumes_from_a_jax_checkpoint(jax_gate, monkeypatch):
    """The port's gate at SMALL on the JAX tool's checkpoint: it resumes
    (no mapping), and scores the restored map as the JAX tool did: the same
    iterations, alive count and drops, PSNR within 1e-3 dB, SSIM within
    1e-4 and kp contrast within 1e-3 relative (the same map rendered
    through each package's tiled blend, which agree to 5e-5)."""
    path, ref = jax_gate
    assert not ref["resumed"]
    assert sorted(os.listdir(path)) == ["ckpt.npz", "ckpt.npz.hostrng",
                                        "progress.jsonl"]
    _gate_env(monkeypatch, path)
    _unrounded(monkeypatch, tgate)
    res = tgate.main(**SMALL, device="cpu")
    assert tuple(res) == KEYS
    assert res["resumed"]
    for k in ("iters", "n_alive", "n_dropped_total"):
        assert res[k] == ref[k], k
    # on resume the rate is read back from the JAX tool's mapping row
    assert res["iters_per_s"] == ref["iters_per_s"]
    assert abs(res["psnr"] - ref["psnr"]) <= 1e-3, (res, ref)
    assert abs(res["ssim"] - ref["ssim"]) <= 1e-4, (res, ref)
    assert abs(res["kp_contrast"] - ref["kp_contrast"]) <= (
        1e-3 * ref["kp_contrast"]), (res, ref)
    rows = [json.loads(x) for x in (path / "progress.jsonl").read_text()
            .splitlines()]
    assert [r["phase"] for r in rows] == (["mapping"]
                                          + ["eval_view"] * 2 + ["final"]
                                          + ["eval_view"] * 2 + ["final"])


def test_fresh_gate_writes_only_under_its_paths(jax_gate, tmp_path,
                                                monkeypatch):
    """A fresh port run at SMALL maps (iterations and alive count as the
    JAX tool's fresh run), returns finite values under the JAX tool's keys,
    and writes its rows and checkpoint under the given paths only. Its
    eval trace (on here) scores the held-out views once, at the start of
    the global phase, which SMALL's keyframes reach at map_iters: the same
    map the final evaluation scores."""
    _, ref = jax_gate
    progress = (ROOT / "GATE_PROGRESS.jsonl").read_bytes()
    defaults = {p: p.exists() and p.stat().st_mtime_ns
                for p in (tgate.DEFAULT_LOG, tgate.DEFAULT_CKPT)}
    _gate_env(monkeypatch, tmp_path)
    res = tgate.main(**SMALL, device="cpu", trace_evals=True)
    assert tuple(res) == KEYS and not res["resumed"]
    for k in KEYS[:-1]:
        assert np.isfinite(res[k]), (k, res[k])
    assert res["iters"] == ref["iters"] == SMALL["map_iters"]
    assert res["n_alive"] == ref["n_alive"]
    assert res["iters_per_s"] > 0 and res["n_dropped_total"] >= 0
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt.npz", "ckpt.npz.hostrng", "ckpt.npz.torchrng",
        "progress.jsonl"]
    rows = [json.loads(x) for x in (tmp_path / "progress.jsonl").read_text()
            .splitlines()]
    assert [r["phase"] for r in rows] == ["eval_trace", "mapping",
                                          "eval_view", "eval_view", "final"]
    trace = rows[0]
    assert (trace["iter"], trace["alive"]) == (res["iters"], res["n_alive"])
    # the trace row is unrounded, the result line rounded
    assert abs(trace["psnr"] - res["psnr"]) <= 0.005
    assert abs(trace["ssim"] - res["ssim"]) <= 0.0005
    assert abs(trace["kp_contrast"] - res["kp_contrast"]) <= 0.05
    assert (ROOT / "GATE_PROGRESS.jsonl").read_bytes() == progress
    for p, stamp in defaults.items():
        assert (p.exists() and p.stat().st_mtime_ns) == stamp, p


def test_gate_refuses_a_missing_card(monkeypatch):
    """The gate runs on the card unless the CPU is asked for: without a
    card it stops rather than fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        tgate.run(**SMALL)
    with pytest.raises(SystemExit):
        ttable.main()


# --------------------------------------------------------------------------
# the refinement table
# --------------------------------------------------------------------------

def test_table_row_matches_jax():
    """The 5.5 cm / 5 deg row at seed 0 with 2 iterations a level: the
    JAX tool's loop body (its scene, target, start pose and refine_pose on
    its CPU blend path) against the port's refine_case: the same start
    error, the refined poses within 1 mm and 0.05 deg of each other (the
    limits of test_torch_port_localize.py's whole-refinement test), both
    closer to the target than the start."""
    tmag, rdeg, iters = 0.055, 5.0, 2
    r = np.random.default_rng(0)
    scene = jtable.make_scene(r)
    cam = jtable.Camera.create(np.eye(4, dtype=np.float32), 120., 120., 80.,
                               60., 160, 120)
    gt = jtable.render(scene, cam, jtable.RasterConfig(tile_chunk=8))[
        "render"]
    ax = r.normal(size=3); ax = ax / np.linalg.norm(ax)
    tv = r.normal(size=3); tv = tv / np.linalg.norm(tv) * tmag
    xi_true = np.concatenate([tv, ax * np.radians(rdeg)]).astype(np.float32)
    T0 = np.asarray(jtable.transforms.se3_exp(jnp.asarray(xi_true)))
    xi, _ = jtable.refine_pose(scene, cam, T0, gt, iters=iters, lr=2e-3)
    Tj = np.asarray(jtable.transforms.se3_exp(xi)) @ T0

    got = ttable.refine_case(tmag, rdeg, 0, "cpu", iters=iters)
    t0, r0 = jtable.pose_err(T0, np.eye(4))
    assert abs(got["t0"] - t0) < 1e-6 and abs(got["r0"] - r0) < 1e-4
    d, a = ttable.pose_err(got["w2c"], Tj)
    assert d < 1e-3 and a < 0.05, (d, a)
    tj, rj = jtable.pose_err(Tj, np.eye(4))
    assert tj < t0 and rj < r0
    assert got["t1"] < got["t0"] and got["r1"] < got["r0"]
    assert got["info"]["seed_evals"] == 17
