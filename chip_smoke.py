"""Drive the PyTorch/CUDA port (``splatloc_tpu_torch``) on one NVIDIA GPU.

The quickest proof that the port starts on the card. It drives the port's
two main paths through the entry points a user calls: serving the forward
render of a Gaussian map (``raster.render``) at the size of the JAX
package's bench scene, 100,000 Gaussians with C = 4 channels (RGB plus
kp_score), SH degree 0, seen through the Replica calibration (640x480,
configs/replica/base_config.yaml); and the mapping trainer
(``train.mapping.MappingTrainer``) on that configuration, at its full width
and its CLI's capacity of 2^19 Gaussians. Phases:

1. device    a CUDA device is required (no CPU fallback); prints its name
             and ``nvidia-smi``'s name and power limit
2. build     compiles every kernel from ``splatloc_tpu_torch/csrc`` with
             nvcc, one process per source, all started together
3. scene     makes the scene from ``--seed`` with numpy, writes it with the
             port's PLY writer, loads it back onto the card
4. serve     renders four query poses (the identity and three se3_exp
             perturbations) with every kernel's launch count set to 0 just
             before and read just after
5. kernels   runs the forward walk and its plain PyTorch version on the card
             on the inputs the main path gives it, and fails past the stated
             tolerances
6. timing    CUDA-event times of the forward walk (host-ahead, and
             host-paced as earlier runs took them: event_ms), of its plain
             version and of a whole render, and a torch.profiler breakdown
             of one render (device busy time, idle share, the costliest
             device ops)
7. check     a small render on the card against the port's CPU path (the
             plain versions, which the CPU tests hold to the JAX package)
8. backward  the backward walk (f32 and bf16 slabs) and the per-Gaussian
             reduction against their plain versions at full width, on view
             0 with a seeded cotangent and a slab that held NaN before the
             walk wrote it (the reduction also two launches bit for bit);
             their times, the reduction's yardsticks (index_add_, and
             torch.segment_reduce after a sort) and bounds (its whole
             sort-free path's, and the sorted path's kernel-only one)
9. train     MappingTrainer on the Replica configuration: six keyframes
             rendered along a short path from a room of 100,000 flat splats
             on five walls (the bench scene is a random volume, whose
             rendered depth no depth sensor would report), add_keyframe
             then ten mapping iterations each (a densify at iteration 50),
             then 20 color-refinement iterations, with the launch counts set
             to 0 just before and read just after; the three kernels
             against their plain versions on the trainer's own inputs (the
             last keyframe's view of the trained scene under the caps and
             tiers the trainer ended with) and the reduction's times there,
             beside that view's K, PC and pairs; a checkpoint saved and
             loaded back; step times and a torch.profiler breakdown of one
             mapping step
10. repeat   two trainers with the same seed (two keyframes, ten
             iterations) give bit-identical scenes

Prints a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and no result line is printed.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from splatloc_tpu_torch import build
from splatloc_tpu_torch.cli.config import load_config
from splatloc_tpu_torch.core import sh, transforms
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, hopper_raster, pairs, project
from splatloc_tpu_torch.raster import RasterConfig, render
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train import checkpoint
from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer

WIDTH, HEIGHT = 640, 480
N_GAUSSIANS = 100_000
N_VIEWS = 4
REPO = Path(__file__).resolve().parent
REPLICA_CONFIG = REPO / "configs" / "replica" / "base_config.yaml"
# the mapping CLI's default capacity (cli/train_gaussians.py:92)
TRAIN_CAPACITY = 2 ** 19
N_KEYFRAMES = 6
MAP_ITERS = 10          # mapping_itr_num per keyframe (Replica config)
REFINE_ITERS = 20
# NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# f32 operations of one pair-pixel evaluation of the walk: the quadratic,
# the keep-eps select, the alpha cut and clamp, the transmittance test, and
# one exp (counted as one operation)
OPS_PER_EVAL = 16

# kernel against its plain version on the same inputs. The kernel carries
# T by direct products and the plain version by exp of a log-space cumsum,
# so a pixel whose T lands within rounding of t_eps can flip one pair: that
# moves it by at most ~alpha * t_eps ~ 1e-4 (depths reach 8 m, so 8x that).
TOL = {"channels_max": 2e-4, "depth_max": 2e-3, "mean": 1e-6,
       "t_final_max": 1e-5, "n_contrib_equal": 0.999}
# backward walk against its plain version, relative L2 per gradient row:
# the kernel carries T and the later-pairs sum s by direct products and
# sums, the plain version in log space by triangular products, so the
# per-pair grads agree to float32 rounding (f32 slab) or to one bf16
# rounding of each value (bf16 slab)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the reduction against its plain version: the same float32 values summed
# in another order (a run in order vs a Hillis-Steele scan)
SEG_TOL = 1e-5
# host-ahead timing's first device sleep (~2 ms at the H100's clocks)
SLEEP_CYCLES = 1 << 22
# and its longest: a function that takes the host longer to queue is not
# timed host-ahead
MAX_SLEEP_MS = 200.0


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def synced(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------------------
# scene and cameras
# --------------------------------------------------------------------------

def make_scene(n: int, seed: int, device) -> GaussianScene:
    """The bench scene's distribution (means in a 6x4 m slab 1-8 m deep,
    log-scales in [-5.5, -3.5], opacities in [0.3, 0.95], channels in
    [0, 1]) as a SH-degree-0 GaussianScene: RGB in f_dc, the 4th channel
    in kp_score."""
    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(1.0, 8.0, n)], -1).astype(np.float32)
    scaling = rng.uniform(-5.5, -3.5, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    op = rng.uniform(0.3, 0.95, (n, 1))
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return GaussianScene(
        xyz=t(xyz), f_dc=sh.rgb_to_sh(t(colors[:, None, :3])),
        f_rest=torch.zeros((n, 0, 3), device=device), scaling=t(scaling),
        rotation=t(quats), opacity=t(np.log(op / (1 - op)).astype(np.float32)),
        marker=torch.zeros((n, 1), device=device), kp_score=t(colors[:, 3:]),
        alive=torch.ones((n,), dtype=torch.bool, device=device), sh_degree=0)


def make_room_scene(n: int, seed: int, device) -> GaussianScene:
    """A room for the trainer's keyframes: ``n`` flat splats (3-5 cm across,
    2.5 mm thick) on the back wall, side walls, floor and ceiling of a
    6 x 4 x 8 m box, the camera inside at the origin facing the back wall,
    opacities in [0.6, 0.95], channels in [0, 1]. Its rendered depth is a
    surface's, as a depth sensor reports it; the bench scene's random
    volume renders a depth that jumps by metres between neighbouring
    pixels, so the keyframe initialisation would size its splats tens of
    tiles wide and overflow the binning's tile caps."""
    rng = np.random.default_rng(seed + 3)
    # (axis of the normal, its coordinate, ranges of the other two axes)
    walls = [(2, 8.0, (-3, 3), (-2, 2)),
             (0, -3.0, (-2, 2), (0, 8)), (0, 3.0, (-2, 2), (0, 8)),
             (1, -2.0, (-3, 3), (0, 8)), (1, 2.0, (-3, 3), (0, 8))]
    areas = np.array([(a[1] - a[0]) * (b[1] - b[0])
                      for _, _, a, b in walls], float)
    which = rng.choice(len(walls), size=n, p=areas / areas.sum())
    xyz = np.zeros((n, 3), np.float32)
    scaling = rng.uniform(-4.0, -3.0, (n, 3)).astype(np.float32)
    for i, (k, c, r1, r2) in enumerate(walls):
        m = which == i
        a, b = [j for j in range(3) if j != k]
        xyz[m, k] = c
        xyz[m, a] = rng.uniform(*r1, m.sum())
        xyz[m, b] = rng.uniform(*r2, m.sum())
        scaling[m, k] = -6.0
    op = rng.uniform(0.6, 0.95, (n, 1))
    colors = rng.uniform(0, 1, (n, 4)).astype(np.float32)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return GaussianScene(
        xyz=t(xyz), f_dc=sh.rgb_to_sh(t(colors[:, None, :3])),
        f_rest=torch.zeros((n, 0, 3), device=device), scaling=t(scaling),
        rotation=t(np.tile(np.array([[1.0, 0, 0, 0]], np.float32), (n, 1))),
        opacity=t(np.log(op / (1 - op)).astype(np.float32)),
        marker=torch.zeros((n, 1), device=device), kp_score=t(colors[:, 3:]),
        alive=torch.ones((n,), dtype=torch.bool, device=device), sh_degree=0)


def ply_round_trip(scene: GaussianScene, device) -> GaussianScene:
    """Write the scene with the port's PLY writer and load it back onto
    ``device``; every field must come back bit for bit."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "scene.ply")
        ply.save_scene(scene, path)
        size = Path(path).stat().st_size
        back = ply.load_scene(path, scene.sh_degree, device=device)
    for name in GaussianScene.PARAM_FIELDS + ("alive",):
        a, b = getattr(scene, name), getattr(back, name)
        if a.shape != b.shape or not torch.equal(a.cpu(), b.cpu()):
            raise AssertionError(f"PLY round trip changed {name}")
    log(f"scene: {scene.capacity} Gaussians, PLY {size} bytes, round trip "
        f"exact, on {back.xyz.device}")
    return back


def make_cameras(width: int, height: int, seed: int, device) -> list:
    """The identity pose and three se3_exp perturbations of it (5 cm of
    translation and 0.03 rad of rotation per axis, one sigma). The
    intrinsics are the Replica calibration's (fx = fy = width / 2, the
    principal point at the image centre: 320, 319.5, 239.5 at 640x480)."""
    rng = np.random.default_rng(seed + 1)
    base = Camera.create(np.eye(4, dtype=np.float32), width / 2.0,
                         width / 2.0, (width - 1) / 2.0, (height - 1) / 2.0,
                         width, height, device=device)
    cams = [base]
    for _ in range(N_VIEWS - 1):
        xi = np.concatenate([rng.normal(scale=0.05, size=3),
                             rng.normal(scale=0.03, size=3)])
        delta = transforms.se3_exp(torch.tensor(xi, dtype=torch.float32,
                                                device=device))
        cams.append(base.replace_pose(delta @ base.w2c))
    return cams


def screen(scene: GaussianScene, cam: Camera, cfg: RasterConfig):
    """The projection and depth order ``rasterize`` computes for this
    scene and pose."""
    proj = project.project_gaussians(
        scene.xyz, scene.scaling_activated(), scene.rotation, cam, cfg,
        alive=scene.alive, opacities=scene.opacity_activated())
    return proj, binning.depth_sort(proj)


def size_pair_array(scene, cams, cfg: RasterConfig) -> RasterConfig:
    """Probe-driven pair capacity, as the JAX package's bench sizes it: the
    exact aligned pair-array length the views need, so no pair is
    dropped."""
    need = 0
    for cam in cams:
        proj, order = screen(scene, cam, cfg)
        need = max(need, int(pairs.pair_need(
            proj.xy[order], proj.radius_xy[order], proj.visible[order],
            cam.width, cam.height, cfg)))
    T = (-(-cams[0].width // cfg.tile_size)) * (-(-cams[0].height
                                                   // cfg.tile_size))
    default = pairs.aligned_cap(cfg, scene.capacity, cams[0].width,
                                cams[0].height)
    if need > default:
        cfg = cfg.replace(pair_cap_override=max(need - T * pairs.ALIGN,
                                                pairs.ALIGN))
    log(f"pairs: views need {need}; pair array {default} by default, "
        f"{pairs.aligned_cap(cfg, scene.capacity, cams[0].width, cams[0].height)}"
        f" used")
    return cfg


def drop_counters(scene, cam, cfg: RasterConfig) -> tuple[int, int, int]:
    """(n_dropped, n_trunc, n_vis_dropped) of a render of this view: the
    pair build's drop counters from pair_stats (the render dict carries
    none) and the visible Gaussians beyond cfg.visible_cap."""
    proj, order = screen(scene, cam, cfg)
    _, n_dropped, n_trunc = pairs.pair_stats(
        proj.xy[order], proj.radius_xy[order], proj.visible[order],
        cam.width, cam.height, cfg)
    K = (scene.capacity if cfg.visible_cap is None
         else min(cfg.visible_cap, scene.capacity))
    return (int(n_dropped), int(n_trunc),
            max(int(proj.visible.sum()) - K, 0))


# --------------------------------------------------------------------------
# the main path
# --------------------------------------------------------------------------

def serve(scene, cams, cfg) -> tuple[list, list, dict]:
    """Render every view through ``render``; returns the outputs, the
    synchronised wall seconds of each render, and each kernel's launches in
    this run."""
    outs, secs = [], []
    hopper_raster.fwd_pairwalk.launches = 0
    for cam in cams:
        synced(cam.device)
        t0 = time.perf_counter()
        out = render(scene, cam, cfg)
        synced(cam.device)
        secs.append(time.perf_counter() - t0)
        outs.append(out)
    launches = {"fwd_pairwalk": hopper_raster.fwd_pairwalk.launches}
    return outs, secs, launches


def check_render(out: dict, width: int, height: int) -> None:
    """Finite values of the reference render() shapes, in range."""
    shapes = {"render": (height, width, 3), "kp_prob": (height, width),
              "depth": (height, width), "opacity": (height, width)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k} has shape {tuple(out[k].shape)}, "
                                 f"expected {shape}")
        if not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{k} has non-finite values")
    a = out["opacity"]
    if float(a.min()) < 0 or float(a.max()) > 1 + 1e-5:
        raise AssertionError(f"opacity outside [0, 1]: {float(a.min())} "
                             f"{float(a.max())}")
    if float(a.max()) < 0.5:
        raise AssertionError("nothing was rendered")


def walk_inputs(scene, cam, cfg):
    """The forward walk's inputs (gpair, starts, counts, origins), the
    channel count and the build_pairs dict for one view, built as
    ``render`` builds them."""
    proj, order = screen(scene, cam, cfg)
    colors = torch.cat([sh.sh_to_color(scene.sh_degree, scene.features(),
                                       scene.xyz, cam.camera_center),
                        scene.kp_score], dim=-1)
    gpair, pr, origins = hopper_raster._pair_inputs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c),
        scene.opacity_activated(), proj.depth, colors,
        (proj.radius_x, proj.radius_y), proj.visible, order, cam.width,
        cam.height, cfg)
    return (gpair, pr["starts"], pr["counts"], origins), colors.shape[-1], pr


def compare_walk(got, ref, C: int) -> dict:
    """Kernel against plain version on the [T, C+4, P] accumulators."""
    d = (got - ref).abs()
    img = torch.cat([d[:, :C], d[:, C + 1:C + 2]], dim=1)   # channels, alpha
    m = {"channels_max": float(img.max()),
         "depth_max": float(d[:, C].max()),
         "mean": float(img.mean()),
         "t_final_max": float(d[:, C + 3].max()),
         "n_contrib_equal": float((got[:, C + 2] == ref[:, C + 2]).float()
                                  .mean()),
         "max_abs_err": float(torch.cat([d[:, :C + 2], d[:, C + 3:]],
                                        dim=1).max())}
    bad = [k for k in ("channels_max", "depth_max", "mean", "t_final_max")
           if not m[k] <= TOL[k]]
    if not m["n_contrib_equal"] >= TOL["n_contrib_equal"]:
        bad.append("n_contrib_equal")
    log("fwd_pairwalk vs plain: " + json.dumps(m))
    if bad:
        raise AssertionError(f"fwd_pairwalk disagrees with its plain "
                             f"version on {bad} (limits {TOL})")
    return m


def _bound(bytes_moved: float, n_ops: float, **detail):
    """(bound ms, "bytes" or "operations", detail): the larger of the bytes
    over the memory rate and the f32 operations over their rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), {
        "bytes": bytes_moved, **detail, "bytes_ms": t_bytes, "ops_ms": t_ops}


def walk_bound_ms(args, ref, C: int) -> tuple[float, str, dict]:
    """The least time the card could take for the forward walk on these
    inputs: the larger of the bytes it must move over the memory rate and
    its operations over the f32 rate. Bytes: the N_FIXED + C rows of every
    pair of every segment read once, the tile tables read once and the
    output written once. Operations: each pixel must evaluate the pairs of
    its tile up to its last blended pair (all of them where none blends),
    counted from this run's n_contrib."""
    _, starts, counts, origins = args
    rows_read = hopper_raster.N_FIXED + C
    n_pairs = int(counts.sum())
    bytes_moved = (rows_read * n_pairs * 4
                   + (starts.numel() + counts.numel() + origins.numel()) * 4
                   + ref.numel() * 4)
    nc = ref[:, C + 2, :]                                   # [T, P]
    st = starts[:, None].to(nc.dtype)
    per_pix = torch.where(nc >= 0, nc - st + 1,
                          counts[:, None].to(nc.dtype).expand_as(nc))
    evals = float(per_pix.double().sum())
    return _bound(bytes_moved, evals * OPS_PER_EVAL, pairs=n_pairs,
                  evals=evals)


def event_ms(fn, reps: int, warmup: int = 2, host_ahead: bool = True) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back runs, by CUDA
    events after a warm-up.

    Host-ahead (the default): the stream first sleeps on the device
    (``torch.cuda._sleep``) while the host queues all ``reps`` runs, so the
    events bracket the device's work alone; where the host took longer to
    queue them than the sleep lasted, the sleep is lengthened and the runs
    repeated, up to four times (a function that synchronises inside keeps
    the host behind the device however long it sleeps, and raises), and
    never past MAX_SLEEP_MS: it raises at once when the next sleep would
    be longer.
    Host-paced (``host_ahead=False``, the method of earlier runs): the
    events bracket the host's calls as well, so a kernel of tens of
    microseconds waits for each launch and the time is the host's. The
    plain versions and torch.segment_reduce are timed so: they synchronise
    inside."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def event():
        return torch.cuda.Event(enable_timing=True)
    if not host_ahead:
        start, end = event(), event()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    cycles = SLEEP_CYCLES
    for _ in range(4):
        e0, e1, e2 = event(), event(), event()
        e0.record()
        torch.cuda._sleep(cycles)
        e1.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        e2.record()
        torch.cuda.synchronize()
        slept = e0.elapsed_time(e1)
        if slept > host_ms:
            return e1.elapsed_time(e2) / reps
        if 2 * host_ms > MAX_SLEEP_MS:
            break
        cycles = int(cycles * 2 * host_ms / max(slept, 1e-3)) + 1
    raise RuntimeError(f"the host did not get ahead of the device: "
                       f"{host_ms:.3f} ms to queue {reps} runs, the device "
                       f"slept {slept:.3f} ms (does it synchronise?)")


def profile(fn, wall_ms: float, reps: int) -> dict:
    """Where the time of one call of ``fn`` goes: torch.profiler over
    ``reps`` calls after a warm-up call. Device busy is the summed time of
    the device-side events (kernels, copies, fills) per call; the idle share
    is the rest of ``wall_ms``, the unprofiled time of one call (the
    profiler itself slows the host)."""
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"wall_ms": wall_ms, "profiled_wall_ms": profiled_ms,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_ops_per_call": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:10]]}


def small_reference_check(seed: int) -> dict:
    """A small render on the card against the port's CPU path."""
    w, h, n = 160, 120, 4000
    cfg = RasterConfig(use_pallas=True)
    outs = {}
    for dev in ("cpu", "cuda"):
        scene = make_scene(n, seed + 7, dev)
        cam = make_cameras(w, h, seed, dev)[1]
        outs[dev] = render(scene, cam, cfg)
    diffs = {k: float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max())
             for k in ("render", "kp_prob", "opacity", "depth")}
    limits = {"render": 2e-4, "kp_prob": 2e-4, "opacity": 2e-4,
              "depth": 2e-3}
    log(f"small render ({w}x{h}, {n} Gaussians) card vs CPU path: "
        + json.dumps(diffs))
    bad = [k for k, v in diffs.items() if not v <= limits[k]]
    if bad:
        raise AssertionError(f"card and CPU renders differ on {bad}")
    for k in ("radii", "visibility_filter"):
        if not torch.equal(outs["cuda"][k].cpu(), outs["cpu"][k]):
            raise AssertionError(f"card and CPU renders differ on {k}")
    return diffs


# --------------------------------------------------------------------------
# phase 8: the backward kernels at full width
# --------------------------------------------------------------------------

def segment_mask(starts, counts, pc: int):
    """[PC] bool: the positions of the tiles' 128-aligned segments (the
    slab rows the backward walk writes): the zero-filled part of every
    segment when no chunk is walked."""
    return hopper_raster._zero_fill_mask(starts, counts,
                                         torch.full_like(starts, -1), pc)


def rel_l2(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / b.double().norm().clamp_min(1e-30))


def poisoned_empty(shape, dtype, device) -> int:
    """Fill a block of ``shape`` with NaN and free it; the caching
    allocator hands that block to the next allocation of the same size, so
    a kernel's ``torch.empty`` output starts out as NaN. Returns its
    address, which the caller checks."""
    if torch.device(device).type != "cuda":
        return None                 # only the card's allocator caches
    x = torch.full(shape, float("nan"), dtype=dtype, device=device)
    ptr = x.data_ptr()
    del x
    return ptr


def bwd_inputs(walk_args, fwd_out, C: int, seed: int):
    """The backward walk's inputs for one view: the forward's, its output,
    a seeded cotangent and the per-tile last contributing chunk."""
    gpair, starts, counts, origins = walk_args
    g = torch.Generator(device=fwd_out.device).manual_seed(seed + 2)
    cot = torch.randn((fwd_out.shape[0], C + 2, fwd_out.shape[2]),
                      generator=g, device=fwd_out.device)
    jhi = hopper_raster._jhi(fwd_out, starts, counts, C)
    return (gpair, starts, counts, origins, jhi, fwd_out, cot)


def compare_bwd(args, C: int, cfg, dtype) -> dict:
    """K2 (into a slab that held NaN) against its plain version: relative
    L2 per gradient row over the written rows, zeros past each tile's
    jhi; and a second launch on the same inputs, bit for bit the same."""
    gpair, starts, counts = args[0], args[1], args[2]
    PC, rows = gpair.shape[1], gpair.shape[0]
    ref = hopper_raster.bwd_pairwalk_plain(*args, C, cfg, dtype)
    ptr = poisoned_empty((PC, rows), dtype, gpair.device)
    got = hopper_raster.bwd_pairwalk(*args, C, cfg, dtype)
    synced(gpair.device)
    if ptr is not None and got.data_ptr() != ptr:
        raise AssertionError("the backward slab did not reuse the "
                             "NaN-filled block")
    mask = segment_mask(starts, counts, PC)
    again = hopper_raster.bwd_pairwalk(*args, C, cfg, dtype)
    g, r = got[mask].float(), ref[mask].float()
    per_row = [rel_l2(g[:, i], r[:, i])
               for i in range(hopper_raster.N_FIXED + C)]
    m = {"dtype": str(dtype).replace("torch.", ""),
         "rows_rel_l2_max": max(per_row),
         "repeat_bitwise": bool(torch.equal(got[mask], again[mask])),
         "finite": bool(torch.isfinite(g).all()),
         "pad_rows_zero": bool((g[:, hopper_raster.N_FIXED + C:] == 0).all()),
         "max_abs_err": float((g - r).abs().max()),
         "written_rows": int(mask.sum())}
    log("bwd_pairwalk vs plain: " + json.dumps(m))
    if not (m["finite"] and m["pad_rows_zero"] and m["repeat_bitwise"]
            and m["rows_rel_l2_max"] <= BWD_TOL[dtype]):
        raise AssertionError(f"bwd_pairwalk disagrees with its plain version "
                             f"({m}; limit {BWD_TOL[dtype]})")
    return m, got


def seg_inputs(slab, pr):
    """The reduction's inputs as _backward_impl passes them."""
    return (slab, pr["pair_idx"], pr["per_rank_counts"])


def compare_seg(seg_args, kmax: int) -> dict:
    """K3 against its plain version, and a second launch bit for bit the
    first."""
    ref = hopper_raster.seg_reduce_plain(*seg_args, kmax)
    got = hopper_raster.seg_reduce(*seg_args, kmax)
    again = hopper_raster.seg_reduce(*seg_args, kmax)
    synced(got.device)
    m = {"rel_l2": rel_l2(got, ref), "finite": bool(torch.isfinite(got).all()),
         "zero_rows_equal": bool(torch.equal(got == 0, ref == 0)),
         "repeat_bitwise": bool(torch.equal(got, again)),
         "max_abs_err": float((got - ref).abs().max()),
         "ranks": int(got.shape[0])}
    log("seg_reduce vs plain: " + json.dumps(m))
    if not (m["finite"] and bool(torch.isfinite(ref).all())
            and m["zero_rows_equal"] and m["repeat_bitwise"]
            and m["rel_l2"] <= SEG_TOL):
        raise AssertionError(f"seg_reduce disagrees with its plain version "
                             f"({m}; limit {SEG_TOL})")
    return m


def ops_per_blend(C: int) -> int:
    """f32 operations a blended pair-pixel evaluation of the backward walk
    adds to the forward's OPS_PER_EVAL: the transmittance division, u (C + 2
    products and sums), w, dalpha, s, dpower and dop (~10), the 8 + C
    per-pixel terms and their 8 + C additions into the tile's sums."""
    return 2 + 2 * (C + 2) + 10 + 2 * (8 + C)


def walk_evals(args, C: int, cfg) -> tuple[float, float]:
    """(evaluations, blended evaluations) the backward walk must make on
    these inputs. Each pixel evaluates the pairs of its tile up to its own
    last blended pair (none where nothing blends), from this run's
    n_contrib; an evaluation blends where the pair is kept at or before
    n_contrib, counted chunk by chunk as the plain walk's mask."""
    gpair, starts, counts, origins, jhi, fwd_out, _ = args
    nc = fwd_out[:, C + 2, :]
    st = starts[:, None].to(nc.dtype)
    evals = float(torch.where(nc >= 0, nc - st + 1,
                              torch.zeros_like(nc)).double().sum())
    PC, ts, T = gpair.shape[1], cfg.tile_size, starts.shape[0]
    flat = torch.arange(ts * ts, device=gpair.device)
    p, q = (flat % ts).float(), (flat // ts).float()
    monos = (p, q, p * p, p * q, q * q)
    lane = torch.arange(hopper_raster.CHUNK, device=gpair.device)
    origins2 = origins.reshape(T, 2).float()
    blended = torch.zeros((), dtype=torch.int64, device=gpair.device)
    for b0 in range(0, T, hopper_raster.PLAIN_TILE_BATCH):
        b1 = min(b0 + hopper_raster.PLAIN_TILE_BATCH, T)
        jh = jhi[b0:b1].long()
        for j in range(int(jh.max()) + 1):
            pos = starts[b0:b1, None].long() + j * hopper_raster.CHUNK + lane
            g = gpair[:, pos.clamp(max=PC - 1)]
            power, keep_eps = hopper_raster._pair_power(
                g, origins2[b0:b1, 0:1], origins2[b0:b1, 1:2], monos, ts)
            pm = torch.where(power <= keep_eps[:, None, :],
                             power.clamp(max=0.0),
                             torch.full_like(power, -40.0))
            keep = (g[hopper_raster.R_OP][:, None, :] * torch.exp(pm)
                    >= cfg.alpha_min)
            blended += (keep & (pos.float()[:, None, :] <= nc[b0:b1, :, None])
                        & (jh >= j)[:, None, None]).sum()
    return evals, float(blended)


def bwd_bound_ms(args, C: int, cfg, slab_dtype) -> tuple[float, str, dict]:
    """The least time for the backward walk on these inputs. Bytes: the
    N_FIXED + C rows of every pair the walk must read (each tile's
    segment up to its last blended pair), the forward output and the
    cotangent read once, the slab's written rows written once, the tile
    tables read once. Operations: OPS_PER_EVAL for every evaluation (each
    pixel up to its own last blended pair) and ops_per_blend more for each
    one that blends, counted from this run's data (walk_evals)."""
    gpair, starts, counts, origins, jhi, fwd_out, cot = args
    rows = gpair.shape[0]
    last = fwd_out[:, C + 2, :].amax(1).long()
    needed = int((last - starts.long() + 1).clamp_min(0).sum())
    written = int((torch.div(counts.long() + 127, 128,
                             rounding_mode="floor") * 128).sum())
    esize = torch.tensor([], dtype=slab_dtype).element_size()
    bytes_moved = ((hopper_raster.N_FIXED + C) * needed * 4
                   + (fwd_out.numel() + cot.numel()) * 4
                   + written * rows * esize
                   + (starts.numel() * 3 + origins.numel()) * 4)
    evals, blended = walk_evals(args, C, cfg)
    ops = evals * OPS_PER_EVAL + blended * ops_per_blend(C)
    return _bound(bytes_moved, ops, evals=evals, blended=blended,
                  operations=ops, needed_pairs=needed)


def seg_bound_ms(seg_args) -> tuple[float, str, dict]:
    """The least time for the whole reduction, from pair_idx to [K, rows],
    counted from what the function needs: pair_idx read once (PC x 4 B),
    the emitted counts read once (K x 4 B), the surviving pairs' slab rows
    read once and the [K, rows] float32 result written once; against one
    addition per value read. The sort-free path's own traffic on top of
    that (seg_design_bytes) is not counted."""
    slab, pair_idx, prc = seg_args
    PC, rows = slab.shape
    K = prc.numel()
    n_pairs = int((pair_idx < K).sum())
    bytes_moved = (PC * 4 + K * 4 + n_pairs * rows * slab.element_size()
                   + K * rows * 4)
    return _bound(bytes_moved, n_pairs * rows, pairs=n_pairs)


def seg_design_bytes(seg_args) -> int:
    """The bytes the sort-free design moves beyond seg_bound_ms's: each
    surviving pair's bucket entry written and read (4 B each way), and per
    rank its bucket offset and count written and read (8 B each way) and
    its counter zeroed, counted and read (4 B each)."""
    _, pair_idx, prc = seg_args
    K = prc.numel()
    return int((pair_idx < K).sum()) * 8 + K * (16 + 12)


def seg_kernel_bound_ms(seg_args) -> tuple[float, str, dict]:
    """The bound of the earlier sorted path's kernel alone (the sort, casts
    and cumsum before it not counted): each emitted pair's slab row, perm
    and si entries read once, the run ends read once, the result written
    once."""
    slab, _, prc = seg_args
    rows, K = slab.shape[1], prc.numel()
    n_pairs = int(prc.sum())
    bytes_moved = (n_pairs * (rows * slab.element_size() + 8) + K * 4
                   + K * rows * 4)
    return _bound(bytes_moved, n_pairs * rows, pairs=n_pairs)


def index_add_fn(seg_args):
    """The one-call yardstick: float atomics of the surviving pairs' rows
    into K rows, the same sums as the reduction when nothing was dropped,
    in an order that changes from run to run. The surviving rows and their
    ids are selected (and the rows upcast) outside the timed call, so no
    row takes the filler ids' contended atomics. Timed here; the port never
    calls it."""
    slab, pair_idx, prc = seg_args
    K, rows = prc.numel(), slab.shape[1]
    keep = torch.nonzero(pair_idx < K)[:, 0]
    ids = pair_idx.index_select(0, keep)
    src = slab.index_select(0, keep).float()
    return lambda: torch.zeros((K, rows), device=slab.device).index_add_(
        0, ids, src)


def segment_reduce_fn(seg_args):
    """torch.segment_reduce over the float32 rows gathered in sorted order
    (the sort and gather before it not timed): the same per-rank sums when
    nothing was dropped (the filler is its own last segment)."""
    slab, pair_idx, prc = seg_args
    perm = torch.sort(pair_idx, stable=True).indices
    gathered = slab.index_select(0, perm).float()
    lengths = torch.cat([prc.long(),
                         (slab.shape[0] - prc.long().sum()).reshape(1)])
    return lambda: torch.segment_reduce(gathered, "sum", lengths=lengths)


def time_seg(seg_args, kmax: int, card: str, view: str) -> dict:
    """K3 on one view: host-ahead and host-paced, its plain version, the
    two library yardsticks (each checked against the plain result), and
    both bounds, logged beside the view's K, PC and pairs."""
    slab, pair_idx, prc = seg_args
    ref = hopper_raster.seg_reduce_plain(*seg_args, kmax)
    lib_errs = {"index_add": rel_l2(index_add_fn(seg_args)(), ref),
                "segment_reduce": rel_l2(segment_reduce_fn(seg_args)()[:-1],
                                         ref)}
    b, by, d = seg_bound_ms(seg_args)
    bk, _, dk = seg_kernel_bound_ms(seg_args)
    extra = seg_design_bytes(seg_args)
    t = {"ms": event_ms(lambda: hopper_raster.seg_reduce(*seg_args, kmax),
                        20),
         "ms_host_paced": event_ms(
             lambda: hopper_raster.seg_reduce(*seg_args, kmax), 20,
             host_ahead=False),
         "plain_ms": event_ms(lambda: hopper_raster.seg_reduce_plain(
             *seg_args, kmax), 3, 1, host_ahead=False),
         "library_ms": event_ms(index_add_fn(seg_args), 20),
         # it reads the segment lengths on the host: host-paced
         "segment_reduce_ms": event_ms(segment_reduce_fn(seg_args), 20,
                                       host_ahead=False),
         "bound_ms": b, "bound_by": by, "kernel_bound_ms": bk,
         "design_extra_bytes": extra}
    # the device time of each of the path's launches
    prof = profile(lambda: hopper_raster.seg_reduce(*seg_args, kmax),
                   t["ms"], 20)
    t["kernels_ms"] = {row["name"][:60]: row["ms"] for row in prof["top"]}
    log(f"timing on {card}, {view}: seg_reduce {t['ms']:.4f} ms host-ahead "
        f"({t['ms_host_paced']:.4f} host-paced), plain {t['plain_ms']:.4f} "
        f"ms, index_add_ {t['library_ms']:.4f} ms, torch.segment_reduce "
        f"{t['segment_reduce_ms']:.4f} ms; bound {b:.4f} ms ({by}; "
        f"{json.dumps(d)}), share {b / t['ms']:.4f}; the bucket and "
        f"counters move {extra} B more ({extra / HBM_BYTES_PER_S * 1e3:.4f} "
        f"ms at the memory rate); the sorted path's kernel-only bound "
        f"{bk:.4f} ms ({json.dumps(dk)}); K "
        f"{prc.numel()}, PC {slab.shape[0]}, emitted pairs {int(prc.sum())},"
        f" surviving {d['pairs']}; yardsticks vs plain rel L2 "
        f"{json.dumps(lib_errs)}")
    return t


def check_backward(walk_args, fwd_out, pr, C: int, cfg, seed: int,
                   width: int = WIDTH, height: int = HEIGHT):
    """K2 (f32 and bf16 slabs) and K3 against their plain versions on one
    view's inputs -> (K2's inputs, K3's inputs, kmax, the worst absolute
    error of each)."""
    args = bwd_inputs(walk_args, fwd_out, C, seed)
    m32, _ = compare_bwd(args, C, cfg, torch.float32)
    m16, slab = compare_bwd(args, C, cfg, torch.bfloat16)
    kmax = pairs.big_tiles_for(cfg, width, height)
    # the slab held NaN before K2 ran: its unwritten tail still does
    seg_args = seg_inputs(slab, pr)
    ms_ = compare_seg(seg_args, kmax)
    errs = {"bwd_pairwalk": max(m32["max_abs_err"], m16["max_abs_err"]),
            "seg_reduce": ms_["max_abs_err"]}
    return args, seg_args, kmax, errs


def backward_phase(walk_args, fwd_out, pr, C: int, cfg, seed: int,
                   card: str) -> dict:
    """Phase 8: K2 and K3 against their plain versions at the main path's
    shapes, then their times (host-ahead and host-paced) and bounds."""
    args, seg_args, kmax, errs = check_backward(walk_args, fwd_out, pr, C,
                                                cfg, seed)
    out = {k: {"max_abs_err": v} for k, v in errs.items()}
    dt = hopper_raster.GRAD_SLAB_DTYPE
    k2 = event_ms(lambda: hopper_raster.bwd_pairwalk(*args, C, cfg, dt), 20)
    k2_paced = event_ms(lambda: hopper_raster.bwd_pairwalk(
        *args, C, cfg, dt), 20, host_ahead=False)
    k2_plain = event_ms(lambda: hopper_raster.bwd_pairwalk_plain(
        *args, C, cfg, dt), 3, 1, host_ahead=False)
    b2, by2, d2 = bwd_bound_ms(args, C, cfg, dt)
    out["bwd_pairwalk"].update(ms=k2, ms_host_paced=k2_paced,
                               plain_ms=k2_plain, bound_ms=b2, bound_by=by2,
                               library_ms=None)
    log(f"timing on {card} ({str(dt)[6:]} slab): bwd_pairwalk {k2:.4f} ms "
        f"host-ahead ({k2_paced:.4f} host-paced), plain {k2_plain:.4f} ms, "
        f"bound {b2:.4f} ms ({by2}; {json.dumps(d2)}), share of the bound "
        f"{b2 / k2:.4f}; no single PyTorch call computes the walk "
        f"(library_ms null)")
    out["seg_reduce"].update(time_seg(seg_args, kmax, card, "serve view 0"))
    return out


# --------------------------------------------------------------------------
# phases 9 and 10: the mapping trainer
# --------------------------------------------------------------------------

def make_keyframes(scene, cfg: MappingConfig, n: int, device) -> list:
    """``n`` RGB-D keyframes of the scene along a short path (5 cm steps
    in x and a slow turn about y), rendered with the port's ``render``: RGB
    in [0, 1]; depth as a depth sensor reports it, the rendered expected
    depth over the rendered alpha where alpha > 0.5 and 0 (no reading)
    elsewhere (the un-normalised expected depth would put the back-projected
    points of faint pixels near the camera); and a score of 0.5 on every
    7th pixel each way (tests/test_train.py's synthetic score)."""
    base = Camera.create(np.eye(4, dtype=np.float32), cfg.fx, cfg.fy,
                         cfg.cx, cfg.cy, cfg.width, cfg.height,
                         device=device)
    poses = []
    for i in range(n):
        xi = torch.tensor([0.05 * i, 0.0, 0.0, 0.0, 0.01 * i, 0.0],
                          dtype=torch.float32, device=device)
        poses.append(transforms.se3_exp(xi))
    cams = [base.replace_pose(w) for w in poses]
    rcfg = size_pair_array(scene, cams, RasterConfig(use_pallas=True))
    frames = []
    for cam in cams:
        with torch.no_grad():
            out = render(scene, cam, rcfg)
        rgb = out["render"].clamp(0, 1).cpu().numpy()
        alpha = out["opacity"]
        depth = torch.where(alpha > 0.5, out["depth"] / alpha.clamp_min(0.5),
                            torch.zeros_like(alpha)).cpu().numpy()
        score = np.zeros((cfg.height, cfg.width), np.float32)
        score[::7, ::7] = 0.5
        frames.append((rgb, depth, score,
                       cam.w2c.cpu().numpy().astype(np.float32)))
    return frames


def reset_launches() -> None:
    for k in (hopper_raster.fwd_pairwalk, hopper_raster.bwd_pairwalk,
              hopper_raster.seg_reduce):
        k.launches = 0


def read_launches() -> dict:
    return {"fwd_pairwalk": hopper_raster.fwd_pairwalk.launches,
            "bwd_pairwalk": hopper_raster.bwd_pairwalk.launches,
            "seg_reduce": hopper_raster.seg_reduce.launches}


def profile_step(trainer, reps: int = 2) -> dict:
    """Where a mapping step's time goes: one unprofiled timing of the step
    function on the trainer's state (outputs discarded), then ``profile``
    over ``reps`` steps."""
    V = trainer.cfg.window_size
    frames = trainer.frames.gather(np.resize(np.arange(trainer.frames.n),
                                             V))

    def step():
        return trainer._mapping_step(trainer.scene, trainer.opt_state,
                                     trainer.stats, frames,
                                     trainer.iteration)
    step()
    synced(trainer.device)
    t0 = time.perf_counter()
    step()
    synced(trainer.device)
    return profile(step, (time.perf_counter() - t0) * 1e3, reps)


def train_view(trainer, frame):
    """(walk inputs, channels, build_pairs dict, raster config) of one
    keyframe's view of the trained scene under the caps and tiers the
    trainer ended with (its pair_cap_override and visible_cap K, most of
    whose ranks have no pairs)."""
    cfg = trainer.cfg
    rcfg = cfg.raster_config()
    cam = Camera.create(frame[3], cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.width,
                        cfg.height, device=trainer.device)
    with torch.no_grad():
        walk_args, C, pr = walk_inputs(trainer.scene, cam, rcfg)
    return walk_args, C, pr, rcfg


def train_kernel_check(trainer, frame, seed: int, card: str) -> dict:
    """The three kernels against their plain versions on the trainer's own
    inputs (train_view), and the reduction's times there."""
    cfg = trainer.cfg
    walk_args, C, pr, rcfg = train_view(trainer, frame)
    with torch.no_grad():
        got = hopper_raster.fwd_pairwalk(*walk_args, C, rcfg)
        ref = hopper_raster.fwd_pairwalk_plain(*walk_args, C, rcfg)
        synced(trainer.device)
        m = compare_walk(got, ref, C)
        _, seg_args, kmax, errs = check_backward(
            walk_args, got, pr, C, rcfg, seed, cfg.width, cfg.height)
        seg_t = time_seg(seg_args, kmax, card, "train view")
    res = {"fwd_pairwalk": m["max_abs_err"], **errs,
           "pair_array": int(walk_args[0].shape[1]),
           "ranks": int(pr["per_rank_counts"].numel()),
           "pairs": int(pr["per_rank_counts"].sum()), "kmax": kmax,
           "seg_reduce_timing": seg_t}
    log("train: kernels vs plain on the trainer's inputs " + json.dumps(res))
    return res


def check_scene(trainer) -> None:
    alive = trainer.scene.alive
    for k in GaussianScene.PARAM_FIELDS:
        x = getattr(trainer.scene, k)[alive]
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"non-finite {k} in the trained scene")


def checkpoint_round_trip(trainer, cfg, seed: int) -> None:
    """Save the trainer, load into a fresh one; every field equal."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "ckpt.npz")
        checkpoint.save(trainer, path)
        back = MappingTrainer(cfg, capacity=trainer.scene.capacity - 640,
                              frame_capacity=trainer.frames.capacity,
                              seed=seed + 1, device=trainer.device)
        checkpoint.load(back, path)
    for k in GaussianScene.PARAM_FIELDS + ("alive",):
        if not torch.equal(getattr(back.scene, k), getattr(trainer.scene, k)):
            raise AssertionError(f"checkpoint round trip changed scene {k}")
    for k in GaussianScene.PARAM_FIELDS:
        if not (torch.equal(back.opt_state.m[k], trainer.opt_state.m[k])
                and torch.equal(back.opt_state.v[k], trainer.opt_state.v[k])):
            raise AssertionError(f"checkpoint round trip changed Adam {k}")
    if (back.iteration, back.frames.n) != (trainer.iteration,
                                           trainer.frames.n):
        raise AssertionError("checkpoint round trip changed the counters")
    log("checkpoint: save and load exact (scene, Adam, frames, counters)")


def replica_config(**changes) -> MappingConfig:
    """The trainer's configuration from the shipped Replica config;
    ``changes`` (a CPU rehearsal's smaller image) replace fields."""
    cfg = MappingConfig.from_config(load_config(str(REPLICA_CONFIG)))
    return dataclasses.replace(cfg, **changes)


def train_phase(scene, seed: int, device, card: str,
                capacity: int = TRAIN_CAPACITY, n_keyframes: int = N_KEYFRAMES,
                map_iters: int = MAP_ITERS, refine_iters: int = REFINE_ITERS,
                cfg_changes: dict | None = None) -> dict:
    """Phase 9: the mapping trainer on the Replica configuration."""
    cfg = replica_config(**(cfg_changes or {}))
    frames = make_keyframes(scene, cfg, n_keyframes, device)
    trainer = MappingTrainer(cfg, capacity=capacity, seed=seed,
                             device=device)
    synced(device)
    losses, step_s, densify_at = [], [], []
    reset_launches()
    t_start = time.perf_counter()
    for f in frames:
        trainer.add_keyframe(*f)
        for _ in range(map_iters):
            t0 = time.perf_counter()
            losses.append(trainer.map(1))      # the loss read syncs
            step_s.append(time.perf_counter() - t0)
            if (trainer.iteration % cfg.gaussian_update_every
                    == cfg.gaussian_update_offset):
                densify_at.append(trainer.iteration)
    t0 = time.perf_counter()
    refine_loss = trainer.color_refinement(refine_iters)
    synced(device)
    refine_s = time.perf_counter() - t0
    launches = read_launches()
    wall_s = time.perf_counter() - t_start

    n_map = n_keyframes * map_iters
    want = cfg.window_size * n_map + refine_iters
    # steady steps: past the first keyframe (one-time set-up) and not the
    # densify iterations
    steady = [s for i, s in enumerate(step_s, start=1)
              if i > map_iters and i not in densify_at]
    res = {"mapping_iterations": n_map, "refine_iterations": refine_iters,
           "loss_first": losses[0], "loss_last": losses[-1],
           "refine_loss": refine_loss, "alive": int(trainer.scene.num_alive),
           "capacity": trainer.scene.capacity,
           "visible_cap": trainer.cfg.visible_cap,
           "pair_cap_override": trainer.cfg.pair_cap_override,
           "densify_at": densify_at,
           "step_ms_mean": float(np.mean(steady)) * 1e3,
           "step_ms_min": float(np.min(steady)) * 1e3,
           "step_ms_max": float(np.max(steady)) * 1e3,
           "first_step_ms": step_s[0] * 1e3,
           "refine_step_ms_mean": refine_s / refine_iters * 1e3,
           "wall_s": wall_s, "n_dropped_total": trainer.n_dropped_total}
    log(f"train on {card}: " + json.dumps(res))
    log(f"train: launches {json.dumps(launches)} for {n_map} mapping "
        f"iterations of {cfg.window_size} views and {refine_iters} "
        f"refinement iterations (expected {want} each)")
    if any(v != want for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if trainer.n_dropped_total != 0:
        raise AssertionError(f"{trainer.n_dropped_total} pairs dropped")
    if not (all(np.isfinite(losses)) and np.isfinite(refine_loss)):
        raise AssertionError(f"non-finite loss: {losses} {refine_loss}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"mapping loss did not fall: first "
                             f"{losses[0]}, last {losses[-1]}")
    check_scene(trainer)
    kernel_errs = train_kernel_check(trainer, frames[-1], seed, card)
    checkpoint_round_trip(trainer, cfg, seed)
    log("train step profile: " + json.dumps(profile_step(trainer)))
    return {"launches": launches, "kernel_errs": kernel_errs, **res}


def determinism_phase(scene, seed: int, device,
                      capacity: int = TRAIN_CAPACITY,
                      cfg_changes: dict | None = None) -> None:
    """Phase 10: two trainers with the same seed, two keyframes, ten
    iterations: bit-identical xyz and opacity."""
    cfg = replica_config(**(cfg_changes or {}))
    frames = make_keyframes(scene, cfg, 2, device)

    def run():
        t = MappingTrainer(cfg, capacity=capacity, seed=seed + 5,
                           device=device)
        for f in frames:
            t.add_keyframe(*f)
        t.map(10)
        return t

    a, b = run(), run()
    for k in ("xyz", "opacity", "alive"):
        if not torch.equal(getattr(a.scene, k), getattr(b.scene, k)):
            raise AssertionError(f"two trainers with one seed differ on {k}")
    log(f"repeat: two trainers with seed {seed + 5} bit-identical on xyz, "
        f"opacity and alive ({int(a.scene.num_alive)} Gaussians alive)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is False); the port's kernels run "
                         "only on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    # the plain versions' matrix products stay full float32 (not TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {name}, {torch.cuda.device_count()} visible; "
        f"nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = build.build_all()
    for b in built.values():
        log(f"build {b.name}: {b.seconds:.2f} s nvcc -> {b.path.name}")
        for line in b.log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "smem", "spill")):
                log(f"  ptxas: {line.strip()}")
    log(f"build: {time.perf_counter() - t0:.2f} s wall for "
        f"{len(built)} kernel(s)")
    rc = RasterConfig(use_pallas=True)
    log("fwd_pairwalk launch at C = 4: " + json.dumps(
        hopper_raster.fwd_pairwalk_info(4, rc)))
    log("bwd_pairwalk launch at C = 4 (bf16 and f32 slabs): " + json.dumps(
        {str(dt)[6:]: hopper_raster.bwd_pairwalk_info(4, rc, dt)
         for dt in (torch.bfloat16, torch.float32)}))

    # 3. scene
    scene = ply_round_trip(make_scene(N_GAUSSIANS, args.seed, "cpu"), dev)
    cams = make_cameras(WIDTH, HEIGHT, args.seed, dev)
    cfg = size_pair_array(scene, cams, RasterConfig(use_pallas=True))

    # 4. serve: the main path, counts set to 0 just before, read just after
    outs, secs, launches = serve(scene, cams, cfg)
    for i, (out, s) in enumerate(zip(outs, secs)):
        check_render(out, WIDTH, HEIGHT)
        log(f"view {i}: render {s * 1e3:.3f} ms wall (synchronised), "
            f"visible {int(out['visibility_filter'].sum())}, "
            f"alpha mean {float(out['opacity'].mean()):.4f}")
    counters = [drop_counters(scene, cam, cfg) for cam in cams]
    for i, c in enumerate(counters):
        log(f"view {i}: n_dropped {c[0]}, n_trunc {c[1]}, "
            f"n_vis_dropped {c[2]}")
        if any(c):
            raise AssertionError(f"view {i} dropped pairs or Gaussians: {c}")
    log(f"launches on the main path: {json.dumps(launches)}")
    if launches["fwd_pairwalk"] != len(cams):
        raise AssertionError(f"fwd_pairwalk launched "
                             f"{launches['fwd_pairwalk']} times for "
                             f"{len(cams)} renders")

    # 5. kernel against plain version at the main path's shapes
    walk_args, C, pr0 = walk_inputs(scene, cams[0], cfg)
    gpair = walk_args[0]
    log(f"walk inputs: gpair {tuple(gpair.shape)} "
        f"({gpair.numel() * 4 / 1e6:.1f} MB), {walk_args[1].numel()} tiles, "
        f"{int(walk_args[2].sum())} pairs")
    got = hopper_raster.fwd_pairwalk(*walk_args, C, cfg)
    ref = hopper_raster.fwd_pairwalk_plain(*walk_args, C, cfg)
    torch.cuda.synchronize()
    m = compare_walk(got, ref, C)

    # 6. timing
    ms = event_ms(lambda: hopper_raster.fwd_pairwalk(*walk_args, C, cfg), 20)
    ms_paced = event_ms(lambda: hopper_raster.fwd_pairwalk(*walk_args, C,
                                                           cfg), 20,
                        host_ahead=False)
    plain_ms = event_ms(
        lambda: hopper_raster.fwd_pairwalk_plain(*walk_args, C, cfg), 3, 1,
        host_ahead=False)
    bound_ms, bound_by, detail = walk_bound_ms(walk_args, ref, C)
    # a whole render is timed as its caller pays it, host included
    render_ms = event_ms(lambda: render(scene, cams[0], cfg), 10,
                         host_ahead=False)
    log(f"timing on {card}: fwd_pairwalk {ms:.4f} ms host-ahead "
        f"({ms_paced:.4f} host-paced), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}; {json.dumps(detail)}), share of the "
        f"bound {bound_ms / ms:.4f}, whole render {render_ms:.4f} ms")
    log("library: no single PyTorch call computes the pair walk, so there "
        "is no library yardstick (library_ms null)")
    log("profile of one render: " + json.dumps(
        profile(lambda: render(scene, cams[0], cfg), render_ms, 3)))

    # 7. a small render against the CPU path
    small_reference_check(args.seed)

    # 8. the backward kernels at the main path's shapes (view 0)
    bwd = backward_phase(walk_args, got, pr0, C, cfg, args.seed, card)

    # 9. train: the second main path, counts set to 0 just before, read
    # just after (inside train_phase), on keyframes rendered from a room
    room = make_room_scene(N_GAUSSIANS, args.seed, dev)
    train = train_phase(room, args.seed, dev, card)

    # 10. repeat runs are bit-identical
    determinism_phase(room, args.seed, dev)

    paths = {"serve": launches, "train": train["launches"]}

    def launched(k):
        return {"launches": sum(p.get(k, 0) for p in paths.values()),
                "launches_by_path": {n: p.get(k, 0)
                                     for n, p in paths.items()}}

    # the worst error against the plain version over phases 5, 8 and 9
    m["max_abs_err"] = max(m["max_abs_err"],
                           train["kernel_errs"]["fwd_pairwalk"])
    for k in ("bwd_pairwalk", "seg_reduce"):
        bwd[k]["max_abs_err"] = max(bwd[k]["max_abs_err"],
                                    train["kernel_errs"][k])
    # the reduction on the train path's own view, beside serve view 0's
    bwd["seg_reduce"]["train_view"] = train["kernel_errs"][
        "seg_reduce_timing"]

    src = "splatloc_tpu_torch/csrc/"
    ref = "splatloc_tpu/raster/pallas_raster.py:"
    kernels = [
        {"name": "fwd_pairwalk", "route": "cuda",
         "source": src + "fwd_pairwalk.cu", "replaces": ref + "175",
         **launched("fwd_pairwalk"),
         "max_abs_err": m["max_abs_err"], "ms": ms,
         "ms_host_paced": ms_paced, "plain_ms": plain_ms,
         "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None},
        {"name": "bwd_pairwalk", "route": "cuda",
         "source": src + "bwd_pairwalk.cu", "replaces": ref + "357",
         **launched("bwd_pairwalk"), **bwd["bwd_pairwalk"]},
        {"name": "seg_reduce", "route": "cuda",
         "source": src + "seg_reduce.cu", "replaces": ref + "736",
         **launched("seg_reduce"), **bwd["seg_reduce"]},
        # _compact_copy_kernel's upcast is seg_reduce's load: the same
        # launches and times
        {"name": "compact_copy", "route": "cuda",
         "source": src + "seg_reduce.cu", "replaces": ref + "703",
         "folded_into": "seg_reduce",
         **launched("seg_reduce"), **bwd["seg_reduce"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    # the run uses one device, cuda:0, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
