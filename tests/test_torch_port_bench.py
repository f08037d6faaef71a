"""The port's benchmark and profiling programs
(``splatloc_tpu_torch.tools.{bench,bench_pose,bench_refine,profile_bench,
profile_chain,profile_map}``) against the repo's JAX programs (``bench.py``,
``bench_pose.py``, ``tools/bench_refine.py``, ``tools/profile_*.py``) at a
small size on the CPU.

``bench.py``'s measurement is a closure of its child process, and
``bench_pose.main`` and ``tools/profile_map.py`` hard-code their sizes, so
their reference side here is a mirror of their steps built from the JAX
package's public functions (``rasterize``, ``pairs.pair_need``,
``transforms.se3_exp``, ``MappingTrainer``) at the port run's sizes.
``tools/bench_refine.main`` is held in
``test_torch_port_bench_refine.py`` (its own file, so that xdist runs it
beside this one). The JAX pair path runs its Pallas kernels in interpret
mode on the CPU, as the JAX package's own tests run them.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splatloc_tpu.core import transforms as jtransforms
from splatloc_tpu.core.camera import Camera as JCamera
from splatloc_tpu.raster import RasterConfig as JConfig
from splatloc_tpu.raster import binning as jbinning
from splatloc_tpu.raster import pairs as jpairs
from splatloc_tpu.raster import project as jproject
from splatloc_tpu.raster import rasterize as jrasterize
from splatloc_tpu.train.mapping import MappingConfig as JMappingConfig
from splatloc_tpu.train.mapping import MappingTrainer as JMappingTrainer
from splatloc_tpu_torch.raster import pairs as tpairs
from splatloc_tpu_torch.raster.types import RasterConfig as TConfig
from splatloc_tpu_torch.tools import bench, bench_pose, profile_bench
from splatloc_tpu_torch.tools import profile_chain, profile_map

torch.set_num_threads(1)

# the small size of the step tests: 64x48, 2,000 Gaussians
SMALL = dict(H=48, W=64, N=2000)
RENDER_TOL, GRAD_RTOL, XI_TOL = 5e-5, 1e-3, 1e-6


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# the JAX programs' steps, as they are written
# --------------------------------------------------------------------------

def jax_make_inputs(H, W, N):
    """``bench.py:106-119`` (``child``'s ``make_inputs``)."""
    rng = np.random.default_rng(0)
    means = np.stack([
        rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
        rng.uniform(1.0, 8.0, N)], -1).astype(np.float32)
    scales = np.exp(rng.uniform(-5.5, -3.5, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, N).astype(np.float32)
    colors = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    target = rng.uniform(0, 1, (H, W, 4)).astype(np.float32)
    cam = JCamera.create(np.eye(4, dtype=np.float32), W / 2.0, W / 2.0,
                         W / 2, H / 2, W, H)
    args = tuple(map(jnp.asarray, (means, scales, quats, opac, colors)))
    return cam, args, jnp.asarray(target)


def jax_bench_config():
    """``bench.py:130-131``."""
    return JConfig(tile_size=16, max_per_tile=1024, tile_chunk=64,
                   use_pallas=True, max_tiles=6)


def jax_probe_caps(cam, args, cfg, N, H, W):
    """``bench.py:127-146``: (the config, the probed need)."""
    @jax.jit
    def probe(means, scales, quats, opac):
        proj = jproject.project_gaussians(means, scales, quats, cam, cfg,
                                          opacities=opac)
        order = jbinning.depth_sort(proj)
        xys = jnp.take(proj.xy, order, axis=0)
        rxys = jnp.take(proj.radius_xy, order, axis=0)
        viss = jnp.take(proj.visible, order)
        return jpairs.pair_need(xys, rxys, viss, cam.width, cam.height, cfg)

    need = int(jax.block_until_ready(probe(*args[:4])))
    ts = cfg.tile_size
    T = (-(-W // ts)) * (-(-H // ts))
    return dataclasses.replace(
        cfg, pair_cap_override=max(need - T * jpairs.ALIGN, 128)), need


def jax_loss(cam, cfg, tgt):
    """``bench.py:155-157``."""
    def loss_fn(means, scales, quats, opac, colors):
        out = jrasterize(means, scales, quats, opac, colors, cam, cfg)
        return jnp.mean(jnp.abs(out.image - tgt)) + 0.1 * jnp.mean(out.depth)
    return loss_fn


# --------------------------------------------------------------------------
# inputs and probes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stage", bench.STAGES[:2], ids=lambda s: s[0])
def test_make_inputs_is_bit_identical(stage):
    """The three stages' draws (A; B and C share theirs) bit for bit, and
    the camera's intrinsics."""
    _, H, W, N = stage[:4]
    jcam, jargs, jtgt = jax_make_inputs(H, W, N)
    cam, args, tgt = bench.make_inputs(H, W, N, "cpu")
    for a, b in zip(jargs + (jtgt,), args + (tgt,)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())
    for k in ("fx", "fy", "cx", "cy"):
        assert float(getattr(jcam, k)) == float(getattr(cam, k))
    assert (jcam.width, jcam.height) == (cam.width, cam.height)


def test_bench_pose_and_profile_inputs_are_bench_draws():
    """``bench_pose.py``, ``tools/profile_bench.py`` and
    ``tools/profile_chain.py`` draw the same scene as ``bench.py`` (and
    the profile tools the same target) at fx = fy = 320."""
    _, jargs, _ = jax_make_inputs(48, 64, 500)
    cam, args, cfg = bench_pose.make_inputs(48, 64, 500, "cpu")
    for a, b in zip(jargs, args):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert float(cam.fx) == float(cam.fy) == 320.0
    assert (float(cam.cx), float(cam.cy)) == (32.0, 24.0)
    assert cfg.use_pallas is False      # the CPU takes the tiled blend


@pytest.mark.parametrize("caps", ["bench", "profile_chain"])
def test_pair_probe_integers_are_equal(caps):
    """``pair_need``, the ``pair_cap_override`` it sets and the
    ``aligned_cap`` it gives are the JAX program's integers, under
    ``bench.py``'s caps and under ``profile_chain``'s PC_* defaults."""
    H, W, N = SMALL["H"], SMALL["W"], SMALL["N"]
    jcam, jargs, _ = jax_make_inputs(H, W, N)
    cam, args, _ = bench.make_inputs(H, W, N, "cpu")
    if caps == "bench":
        jcfg, tcfg = jax_bench_config(), bench.bench_config()
    else:
        jcfg = JConfig(use_pallas=True, **profile_chain.CAPS)
        tcfg = TConfig(use_pallas=True, **profile_chain.CAPS)
    jcfg2, jneed = jax_probe_caps(jcam, jargs, jcfg, N, H, W)
    tcfg2, tneed = bench.probe_caps(cam, args, tcfg, N, H, W)
    assert tneed == jneed > 0
    assert tcfg2.pair_cap_override == jcfg2.pair_cap_override
    assert (tpairs.aligned_cap(tcfg2, N, W, H)
            == jpairs.aligned_cap(jcfg2, N, W, H))
    assert (tpairs.aligned_cap(tcfg, N, W, H)
            == jpairs.aligned_cap(jcfg, N, W, H))


def test_caps_from_env_reads_the_jax_variables(monkeypatch):
    for k in profile_chain.CAPS:
        monkeypatch.delenv("PC_" + k.upper(), raising=False)
    assert profile_chain.caps_from_env() == {
        "max_tiles": 6, "mid_k": 4096, "mid_tiles": 48, "big_k": 256,
        "big_tiles": 192}
    monkeypatch.setenv("PC_MID_K", "2048")
    assert profile_chain.caps_from_env()["mid_k"] == 2048


# --------------------------------------------------------------------------
# the bench step and the pose step
# --------------------------------------------------------------------------

def test_bench_step_matches_jax():
    """One ``bench.py`` gradient step at 64x48 with 2,000 Gaussians: the
    loss within 5e-5 and the gradients to all five inputs, the depth term
    included, within 1e-3 relative L2; the epsilon update applied to
    every input."""
    H, W, N = SMALL["H"], SMALL["W"], SMALL["N"]
    jcam, jargs, jtgt = jax_make_inputs(H, W, N)
    jl, jg = jax.jit(jax.value_and_grad(
        jax_loss(jcam, jax_bench_config(), jtgt),
        argnums=(0, 1, 2, 3, 4)))(*jargs)
    cam, args, tgt = bench.make_inputs(H, W, N, "cpu")
    cfg = bench.bench_config()
    leaves = [a.clone().requires_grad_(True) for a in args]
    loss = bench.loss_fn(leaves, cam, cfg, tgt)
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(jl)) <= RENDER_TOL
    for name, a, b in zip(("means", "scales", "quats", "opac", "colors"),
                          grads, jg):
        assert bool(torch.isfinite(a).all()), name
        assert float(a.abs().max()) > 0, name
        assert _rel_l2(a.numpy(), b) <= GRAD_RTOL, name
    assert bench.drop_count(args, cam, cfg) == 0
    stepped = bench.grad_step(args, cam, cfg, tgt)
    for p, q, g in zip(stepped, args, grads):
        assert torch.equal(p, q - 1e-12 * g)


def _jax_pose(H, W, N):
    """``bench_pose.py:23-44`` at (H, W, N): (args, cam, cfg, target,
    step)."""
    cam, args, _ = jax_make_inputs(H, W, N)
    cam = JCamera.create(np.eye(4, dtype=np.float32), 320.0, 320.0,
                         W / 2, H / 2, W, H)
    cfg = JConfig(use_pallas=jax.default_backend() != "cpu")
    target = jrasterize(*args, cam, cfg).image

    def loss(xi):
        w2c = jtransforms.se3_exp(xi) @ cam.w2c
        out = jrasterize(*args, cam.replace_pose(w2c), cfg)
        return jnp.mean(jnp.abs(out.image - target))
    return target, jax.jit(jax.grad(loss))


def test_bench_pose_steps_match_jax():
    """``bench_pose``'s target within 5e-5, its twist gradient within 1e-3
    relative L2 and ``xi`` after 3 steps within 1e-6."""
    H, W, N = SMALL["H"], SMALL["W"], SMALL["N"]
    jtarget, jgrad = _jax_pose(H, W, N)
    cam, args, cfg = bench_pose.make_inputs(H, W, N, "cpu")
    from splatloc_tpu_torch.raster import rasterize
    with torch.no_grad():
        target = rasterize(*args, cam, cfg).image
    assert float(np.abs(target.numpy() - np.asarray(jtarget)).max()) \
        <= RENDER_TOL
    assert float(target.abs().max()) > 0
    jxi = jnp.array(bench_pose.XI0)
    xi = torch.tensor(bench_pose.XI0, dtype=torch.float32)
    g = bench_pose.pose_grad(xi, args, cam, cfg, target)
    assert _rel_l2(g.numpy(), jgrad(jxi)) <= GRAD_RTOL
    for _ in range(3):
        jxi = jxi - 1e-3 * jgrad(jxi)
        xi = bench_pose.step(xi, args, cam, cfg, target)
    assert float(np.abs(xi.numpy() - np.asarray(jxi)).max()) <= XI_TOL
    assert not np.array_equal(xi.numpy(), np.asarray(bench_pose.XI0))


# --------------------------------------------------------------------------
# profile_map's trainer
# --------------------------------------------------------------------------

def _jax_profile_map_trainer(n_alive, W, H, fx):
    """``tools/profile_map.py:29-67`` at (n_alive, W, H, fx)."""
    cfg = JMappingConfig(width=W, height=H, fx=fx, fy=fx,
                         cx=(W - 1) / 2, cy=(H - 1) / 2)
    cap = 1 << int(np.ceil(np.log2(n_alive / 0.74)))
    trainer = JMappingTrainer(cfg, capacity=cap, frame_capacity=8)
    rng = np.random.default_rng(0)
    for i in range(6):
        rgb = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        dep = rng.uniform(1.0, 8.0, (H, W)).astype(np.float32)
        sc = np.zeros((H, W), np.float32)
        w2c = np.eye(4, dtype=np.float32)
        w2c[0, 3] = 0.05 * i
        trainer.add_keyframe(rgb, dep, sc, w2c)
    n0 = int(trainer.scene.num_alive)
    add = max(n_alive - n0, 0)
    s = trainer.scene
    idx = np.arange(n0, n0 + add)
    s = s.replace(
        xyz=s.xyz.at[idx].set(jnp.asarray(np.stack(
            [rng.uniform(-3, 3, add), rng.uniform(-2, 2, add),
             rng.uniform(1.0, 8.0, add)], -1).astype(np.float32))),
        scaling=s.scaling.at[idx].set(
            jnp.asarray(rng.uniform(-5.5, -3.5, (add, 3)).astype(np.float32))),
        opacity=s.opacity.at[idx].set(1.0),
        alive=s.alive.at[idx].set(True))
    trainer.scene = s
    trainer._refresh_visible_cap()
    trainer.tighten_pair_cap()
    return trainer, cap, n0


def test_profile_map_fill_matches_jax_trainer():
    """The filled trainer at 20,000 alive and 64x48: the same capacity,
    alive count, fill rows, ``visible_cap`` and ``pair_cap_override`` as
    the JAX trainer built the same way."""
    n_alive, W, H, fx = 20_000, 64, 48, 32.0
    jt, jcap, n0 = _jax_profile_map_trainer(n_alive, W, H, fx)
    tt, cap = profile_map.make_trainer(n_alive, W, H, fx, "cpu")
    assert cap == jcap == 32768
    assert tt.scene.capacity == jt.scene.capacity
    assert int(tt.scene.num_alive) == int(jt.scene.num_alive) == n_alive
    assert np.array_equal(tt.scene.alive.numpy(), np.asarray(jt.scene.alive))
    for k in ("xyz", "scaling", "opacity", "rotation"):
        assert np.array_equal(getattr(tt.scene, k)[n0:n_alive].numpy(),
                              np.asarray(getattr(jt.scene, k))[n0:n_alive]), k
    assert tt.cfg.visible_cap == jt.cfg.visible_cap is not None
    assert tt.cfg.pair_cap_override == jt.cfg.pair_cap_override is not None


# --------------------------------------------------------------------------
# write_result, the trace summarizer, the result lines
# --------------------------------------------------------------------------

def _res(value, headline, stage="s"):
    return {"metric": bench.METRIC, "value": value, "unit": bench.UNIT,
            "vs_baseline": round(value / bench.BASELINE_MPIXS, 3),
            "stage": stage, "headline": headline}


@pytest.mark.parametrize("prev,new,keep", [
    (None, (50.0, False), "new"),                  # the first stage lands
    (_res(90.0, False), (40.0, True), "new"),      # a headline supersedes A
    (_res(40.0, True), (90.0, False), "prev"),     # A never replaces it
    (_res(40.0, True), (45.0, True), "new"),       # best of B and C
    (_res(40.0, True), (40.0, True), "prev"),      # a tie keeps the first
    (_res(40.0, True), (35.0, True), "prev"),
    (_res(40.0, False), (45.0, False), "new"),     # best among A stages
    (_res(40.0, False), (35.0, False), "prev"),
])
def test_write_result_supersede_rule(prev, new, keep):
    mpix, headline = new
    got = bench.write_result(prev, mpix, "new", headline)
    if keep == "prev":
        assert got is prev
    else:
        assert got == _res(round(mpix, 2), headline, "new")
        assert list(got)[:4] == list(bench.RESULT_KEYS)


def _x(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_hand_made_trace():
    """Overlapping spans merge; the silences between the merged spans are
    the idle time; host events and metadata are left out."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 0, "args": {}},
        _x("a", 0, 10), _x("b", 5, 10),             # merged [0, 15)
        _x("Memcpy HtoD", 25, 5, "gpu_memcpy"),      # 10 us after b
        _x("a", 40, 20),                             # 10 us after the copy
        _x("Memset", 60, 2, "gpu_memset"),           # touches a: no gap
        _x("c", 102, 4),                             # 40 us after the fill
        _x("aten::add", 0, 1000, "cpu_op"),
    ]
    s = profile_bench.summarize(events, iters=2)
    assert s["busy_ms"] == pytest.approx((10 + 10 + 5 + 20 + 2 + 4) / 2e3)
    assert s["idle_ms"] == pytest.approx((10 + 10 + 40) / 2e3)
    assert [(o["name"], o["count"]) for o in s["ops"]] == [
        ("a", 1), ("b", 0), ("Memcpy HtoD", 0), ("c", 0), ("Memset", 0)]
    assert s["ops"][0]["ms"] == pytest.approx(30 / 2e3)
    assert [(g["us"], g["after"]) for g in s["gaps"]] == [
        (40, "Memset"), (10, "Memcpy HtoD"), (10, "b")]


def test_summarize_cpu_profiler_run_has_no_device_table():
    events = profile_bench.traced(lambda: torch.ones(64).sum(), "cpu")
    assert any(e.get("ph") == "X" for e in events)
    s = profile_bench.summarize(events, iters=1)
    assert s == {"ops": [], "busy_ms": None, "idle_ms": None, "gaps": []}


# the JAX programs' result keys, in their order
RESULT_KEYS = {
    "bench": ("metric", "value", "unit", "vs_baseline"),     # bench.py:370
    "bench_pose": ("metric", "value", "unit", "vs_baseline"),  # :59-64
    "profile_bench": ("tool", "ms_per_iter", "mpix_s", "device_op_ms",
                      "device_idle_ms"),            # profile_bench.py:125
    "profile_chain": ("tool", "ms_per_iter", "mpix_s", "device_busy_ms",
                      "device_idle_ms"),            # profile_chain.py:177
    "profile_map": ("tool", "ms_per_step", "it_s", "n_alive", "capacity",
                    "device_op_ms"),                # profile_map.py:100-127
}
TINY = dict(H=24, W=32, N=300)
MAINS = {
    "bench": lambda: bench.main(
        "cpu", iters=1, stages=(("tiny", 24, 32, 300, True, True),)),
    "bench_pose": lambda: bench_pose.main("cpu", iters=1, **TINY),
    "profile_bench": lambda: profile_bench.main(1, "cpu", **TINY),
    "profile_chain": lambda: profile_chain.main(1, "cpu", **TINY),
    "profile_map": lambda: profile_map.main(2000, 1, "cpu", W=32, H=24,
                                            fx=16.0),
}


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_tool_prints_one_json_line_with_the_jax_keys(tool, capsys):
    res = MAINS[tool]()
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert tuple(line) == RESULT_KEYS[tool] and line == res
    for k, v in line.items():
        if isinstance(v, float):
            assert np.isfinite(v), k
    if tool.startswith("profile"):
        # no device events on the CPU: the device numbers are not measured
        dev_keys = [k for k in line if k.startswith("device_")]
        assert dev_keys and all(line[k] is None for k in dev_keys)
