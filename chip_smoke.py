"""Drive the PyTorch/CUDA port (``splatloc_tpu_torch``) on one NVIDIA GPU.

The quickest proof that the port starts on the card. It serves the forward
render of a Gaussian map through the entry point a user calls
(``raster.render``), at the size of the JAX package's bench scene: 100,000
Gaussians with C = 4 channels (RGB plus kp_score), SH degree 0, seen
through the Replica calibration (640x480, configs/replica/base_config.yaml).
Phases:

1. device    a CUDA device is required (no CPU fallback); prints its name
             and ``nvidia-smi``'s name and power limit
2. build     compiles every kernel from ``splatloc_tpu_torch/csrc`` with
             nvcc, one process per source, all started together
3. scene     makes the scene from ``--seed`` with numpy, writes it with the
             port's PLY writer, loads it back onto the card
4. serve     renders four query poses (the identity and three se3_exp
             perturbations) with every kernel's launch count set to 0 just
             before and read just after
5. kernels   runs each kernel and its plain PyTorch version on the card on
             the inputs the main path gives it, and fails past the stated
             tolerances
6. timing    CUDA-event times of each kernel and its plain version, of a
             whole render, and a torch.profiler breakdown of one render
             (device busy time, idle share, the costliest device ops)
7. check     a small render on the card against the port's CPU path (the
             plain versions, which the CPU tests hold to the JAX package)

Prints a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and no result line is printed.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from splatloc_tpu_torch import build
from splatloc_tpu_torch.core import sh, transforms
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, hopper_raster, pairs, project
from splatloc_tpu_torch.raster import RasterConfig, render
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.scene.gaussians import GaussianScene

WIDTH, HEIGHT = 640, 480
N_GAUSSIANS = 100_000
N_VIEWS = 4
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
    """The forward walk's inputs (gpair, starts, counts, origins) and the
    channel count for one view, built as ``render`` builds them."""
    proj, order = screen(scene, cam, cfg)
    colors = torch.cat([sh.sh_to_color(scene.sh_degree, scene.features(),
                                       scene.xyz, cam.camera_center),
                        scene.kp_score], dim=-1)
    gpair, pr, origins = hopper_raster._pair_inputs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c),
        scene.opacity_activated(), proj.depth, colors,
        (proj.radius_x, proj.radius_y), proj.visible, order, cam.width,
        cam.height, cfg)
    return (gpair, pr["starts"], pr["counts"], origins), colors.shape[-1]


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
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = evals * OPS_PER_EVAL / FP32_OPS_PER_S * 1e3
    detail = {"pairs": n_pairs, "bytes": bytes_moved, "evals": evals,
              "bytes_ms": t_bytes, "ops_ms": t_ops}
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), detail


def event_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back runs, by CUDA
    events after a warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_render(scene, cam, cfg, render_ms: float, reps: int = 3) -> dict:
    """Where a render's time goes: torch.profiler over ``reps`` renders.
    Device busy is the summed time of the device-side events (kernels,
    copies, fills); the idle share is the rest of ``render_ms``, the
    unprofiled render time (the profiler itself slows the host)."""
    from torch.profiler import ProfilerActivity, profile
    render(scene, cam, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            render(scene, cam, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count // reps)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    return {"render_ms": render_ms, "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy, "idle_share": 1.0 - busy / render_ms,
            "device_ops_per_render": sum(r[2] for r in rows),
            "top": [{"name": k[:80], "ms": ms, "calls": c}
                    for k, ms, c in rows[:8]]}


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
    log("fwd_pairwalk launch at C = 4: " + json.dumps(
        hopper_raster.fwd_pairwalk_info(4, RasterConfig(use_pallas=True))))

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
    walk_args, C = walk_inputs(scene, cams[0], cfg)
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
    plain_ms = event_ms(
        lambda: hopper_raster.fwd_pairwalk_plain(*walk_args, C, cfg), 3, 1)
    bound_ms, bound_by, detail = walk_bound_ms(walk_args, ref, C)
    render_ms = event_ms(lambda: render(scene, cams[0], cfg), 10)
    log(f"timing on {card}: fwd_pairwalk {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bound_ms:.4f} ms ({bound_by}; {json.dumps(detail)}), "
        f"whole render {render_ms:.4f} ms")
    log("library: no single PyTorch call computes the pair walk, so there "
        "is no library yardstick (library_ms null)")
    log("profile: " + json.dumps(profile_render(scene, cams[0], cfg,
                                                render_ms)))

    # 7. a small render against the CPU path
    small_reference_check(args.seed)

    kernels = [{
        "name": "fwd_pairwalk", "route": "cuda",
        "source": "splatloc_tpu_torch/csrc/fwd_pairwalk.cu",
        "replaces": "splatloc_tpu/raster/pallas_raster.py:175",
        "launches": launches["fwd_pairwalk"],
        "max_abs_err": m["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
