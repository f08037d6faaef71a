"""Full-scale synthetic quality gate of the PyTorch port.

Port of ``tools/quality_gate.py``, function by function: a ground-truth
Gaussian scene is rendered at 640x480 into 36 training RGB-D keyframes
(plus held-out eval views) through the tiled blend (``RasterConfig()``);
the mapping trainer reconstructs the scene from scratch through the real
schedule (per-frame RGB-D insertion, windowed 5-view mapping steps,
densify/prune every 150 iterations from 50, the opacity reset at 2001),
growing through >= 100k alive Gaussians; the held-out views are then
rendered on the trainer's raster path (the pair kernels on the card, the
tiled blend on the CPU) and scored with masked PSNR and SSIM, and the kp
channel is checked for marker fidelity (sigmoid of the composited logit at
the ground-truth landmark peaks over the true background).

Resumable as the JAX tool is: the mapping phase checkpoints the trainer to
``SPLATLOC_GATE_CKPT`` (default ``build/gate/ckpt.npz`` in the repo) the
moment it finishes, and every phase appends a row to ``SPLATLOC_GATE_LOG``
(default ``build/gate/progress.jsonl``). A rerun that finds a checkpoint
at ``map_iters`` or beyond, written by either package, skips to the
held-out evaluation.

Run:  python -m splatloc_tpu_torch.tools.quality_gate [map_iters]
      [--device cuda|cpu]        (cuda unless the CPU is asked for)
      [--trace-evals]            (held-out scores every 300 iterations)
Opt-in test:  SPLATLOC_QUALITY_GATE=1 python -m pytest
              tests/test_torch_quality_gate.py --noconftest -s
Passes when mean eval PSNR >= 30, SSIM >= 0.85, kp contrast >= 5x and
>= 100k Gaussians are alive. Prints one JSON line with psnr, ssim,
kp_contrast, n_alive, iters, iters_per_s, n_dropped_total, wall_s and
resumed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
DEFAULT_LOG = REPO / "build" / "gate" / "progress.jsonl"
DEFAULT_CKPT = REPO / "build" / "gate" / "ckpt.npz"


def make_gt_scene(n_gauss: int, rng: np.random.Generator):
    """Structured opaque-ish cloud: room-box walls + floating clutter, so
    depth maps are dense and densification has real work to do."""
    n_wall = n_gauss // 2
    n_free = n_gauss - n_wall
    # walls of a 6x4x8m room (z in [2, 10] in front of the start pose)
    u = rng.uniform(0, 1, (n_wall, 2)).astype(np.float32)
    side = rng.integers(0, 5, n_wall)
    wx = np.where(side == 0, -3.0, np.where(side == 1, 3.0,
                  (u[:, 0] * 6 - 3)))
    wy = np.where(side < 2, u[:, 0] * 4 - 2,
                  np.where(side == 2, -2.0, np.where(side == 3, 2.0,
                           u[:, 1] * 4 - 2)))
    wz = np.where(side < 4, 2.0 + u[:, 1] * 8, 10.0)
    wall = np.stack([wx, wy, wz], -1).astype(np.float32)
    free = np.stack([rng.uniform(-2.5, 2.5, n_free),
                     rng.uniform(-1.6, 1.6, n_free),
                     rng.uniform(2.5, 9.0, n_free)], -1).astype(np.float32)
    means = np.concatenate([wall, free])
    scales = np.exp(rng.uniform(-3.6, -2.6, (n_gauss, 3))).astype(np.float32)
    quats = rng.normal(size=(n_gauss, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = rng.uniform(0.7, 0.98, n_gauss).astype(np.float32)
    # smooth color field so the target is learnable structure, not noise
    colors = (0.5 + 0.45 * np.stack([
        np.sin(means[:, 0] * 1.7) * np.cos(means[:, 2] * 0.9),
        np.sin(means[:, 1] * 2.3 + 1.0),
        np.cos(means[:, 0] * 1.1 + means[:, 2] * 0.7)], -1)
    ).astype(np.float32)
    return means, scales, quats, opac, colors


def orbit_pose(i: int, n: int, jitter=(0.0, 0.0)):
    ang = 0.9 * (i / max(n - 1, 1) - 0.5)
    c2w = np.eye(4, dtype=np.float32)
    c, s = np.cos(ang), np.sin(ang)
    c2w[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    c2w[:3, 3] = [1.8 * s + jitter[0], 0.25 * np.sin(3 * ang) + jitter[1],
                  1.2 * (1 - c)]
    return np.linalg.inv(c2w).astype(np.float32)      # w2c


def score_map(cam0, landmarks: torch.Tensor, w2c: np.ndarray) -> np.ndarray:
    """Blobby keypoint heatmap like a SuperPoint score map (5x5 gaussian
    around each projected landmark): single-pixel spikes are unlearnable
    under BCE — a splat covering ~50 px with one positive pixel optimizes
    to background."""
    W, H = cam0.width, cam0.height
    uv, z = cam0.replace_pose(torch.from_numpy(w2c)).project(landmarks)
    uv, z = uv.cpu().numpy(), z.cpu().numpy()
    sc = np.zeros((H, W), np.float32)
    ui, vi = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(int)
    ok = (z > 0.2) & (ui >= 2) & (ui < W - 2) & (vi >= 2) & (vi < H - 2)
    ui, vi = ui[ok], vi[ok]
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            val = 0.9 * np.exp(-(dx * dx + dy * dy) / 2.0)
            np.maximum.at(sc, (vi + dy, ui + dx), val)
    return sc


def kp_contrast(kp: np.ndarray, sc_gt: np.ndarray) -> float | None:
    """The composited kp channel is a logit (marker_loss is BCE on its
    sigmoid): mean sigmoid at the ground-truth landmark peaks (score > 0.8)
    over the mean at the true background (score < 0.05), the denominator
    floored at 1e-3. Blob fringe pixels (BCE targets 0.1..0.5) belong to
    neither class. None where either class is empty."""
    prob = 1.0 / (1.0 + np.exp(-np.clip(kp, -30, 30)))
    at = sc_gt > 0.8
    bg = sc_gt < 0.05
    if not (at.any() and bg.any()):
        return None
    return float(prob[at].mean() / max(prob[bg].mean(), 1e-3))


def score_views(trainer, evals: list, cam0) -> tuple[list, list, list]:
    """Render each held-out view (gt image, gt score map, w2c) from the
    trainer's scene on its raster path -> per-view masked PSNR, SSIM and kp
    contrast (views with an empty class have none)."""
    from splatloc_tpu_torch.eval.metrics import psnr_masked
    from splatloc_tpu_torch.raster import render
    from splatloc_tpu_torch.train.losses import ssim

    eval_cfg = trainer.cfg.raster_config(trainer.device)
    psnrs, ssims, contrasts = [], [], []
    for img_gt, sc_gt, w2c in evals:
        with torch.no_grad():
            out = render(trainer.scene, cam0.replace_pose(torch.from_numpy(
                w2c)), eval_cfg)
            img = out["render"]
            img_gt_t = torch.from_numpy(img_gt).to(trainer.device)
            psnrs.append(float(psnr_masked(img, img_gt_t)))
            ssims.append(float(ssim(img, img_gt_t)))
        c = kp_contrast(out["kp_prob"].cpu().numpy(), sc_gt)
        contrasts.append(c)
    return psnrs, ssims, contrasts


@dataclasses.dataclass
class GateRun:
    """What ``run`` leaves behind besides the result line: the trainer, the
    held-out views (gt image, gt score map, w2c), the evaluation camera,
    the wall seconds of each phase, the pairs the ground-truth renders
    dropped, the pairs dropped since the trainer's last check (the final
    densify window, which ``n_dropped_total`` does not count yet) and, on
    the card, the peak device memory."""
    result: dict
    trainer: object
    evals: list
    cam0: object
    seconds: dict
    gt_dropped: int
    tail_dropped: int
    peak_mem_gb: float | None


def _synced(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_frames: int = 36, n_eval: int = 4, map_iters: int = 2200,
        n_gauss_gt: int = 60_000, seed: int = 0, W: int = 640, H: int = 480,
        capacity: int = 205_440, device="cuda",
        trace_evals: bool = False) -> GateRun:
    """The gate; ``main`` prints its result line. ``capacity`` is
    pre-sized for the ~150k-alive end state, as the JAX tool's is.
    ``trace_evals`` also scores the held-out views at the start of the
    global phase and after each of its map() calls (every 300 iterations),
    as ``eval_trace`` rows of the progress log (their renders launch the
    forward kernel on the card, and their time counts in iters_per_s)."""
    from splatloc_tpu_torch.core.camera import Camera
    from splatloc_tpu_torch.raster import RasterConfig, rasterize
    from splatloc_tpu_torch.train import checkpoint
    from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quality_gate: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    t_all = time.perf_counter()
    ckpt_path = os.environ.get("SPLATLOC_GATE_CKPT", str(DEFAULT_CKPT))
    log_path = os.environ.get("SPLATLOC_GATE_LOG", str(DEFAULT_LOG))
    os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
    seconds = {}

    def log(msg):
        print(f"[gate +{time.perf_counter() - t_all:.0f}s] {msg}",
              file=sys.stderr, flush=True)

    def progress(row: dict):
        row = {**row, "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())}
        with open(log_path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def trace(trainer):
        p, q, c = score_views(trainer, evals, cam0)
        c = [x for x in c if x is not None]
        row = {"phase": "eval_trace", "iter": trainer.iteration,
               "alive": int(trainer.scene.num_alive),
               "psnr": float(np.mean(p)), "ssim": float(np.mean(q)),
               "kp_contrast": float(np.mean(c)) if c else None}
        progress(row)
        log(f"eval trace: {json.dumps(row)}")

    fx = fy = W / 2.0
    cx, cy = (W - 1) / 2, (H - 1) / 2
    rng = np.random.default_rng(seed)
    gt = make_gt_scene(n_gauss_gt, rng)
    gt_dev = tuple(torch.from_numpy(a).to(dev) for a in gt)
    if dev.type == "cuda":
        # after the first allocation: on a device named by index, the
        # allocator's stats exist only once the context does
        torch.cuda.reset_peak_memory_stats(dev)
    # ~2.5k gt landmarks for the kp/marker channel
    n_lm = 2500
    landmarks = gt[0][rng.permutation(n_gauss_gt)[:n_lm]]
    lm_dev = torch.from_numpy(landmarks).to(dev)

    cfg_r = RasterConfig()
    gt_dropped = 0

    def render_gt(w2c):
        nonlocal gt_dropped
        cam = Camera.create(w2c, fx, fy, cx, cy, W, H, device=dev)
        with torch.no_grad():
            out = rasterize(*gt_dev, cam, cfg_r)
        gt_dropped += int(out.n_dropped)
        return out.image.cpu().numpy(), out.depth.cpu().numpy()

    log(f"rendering {n_frames} train + {n_eval} eval gt frames")
    cam0 = Camera.create(np.eye(4, dtype=np.float32), fx, fy, cx, cy, W, H,
                         device=dev)
    t0 = time.perf_counter()
    frames = []
    for i in range(n_frames):
        w2c = orbit_pose(i, n_frames)
        img, dep = render_gt(w2c)
        frames.append((img[..., :3], dep, score_map(cam0, lm_dev, w2c), w2c))
    evals = []
    for i in range(n_eval):
        w2c = orbit_pose(i * (n_frames - 1) // max(n_eval - 1, 1), n_frames,
                         jitter=(0.04, 0.03))
        img, dep = render_gt(w2c)
        evals.append((img[..., :3], score_map(cam0, lm_dev, w2c), w2c))
    seconds["gt_render"] = time.perf_counter() - t0
    log(f"gt frames: {seconds['gt_render']:.1f} s for {n_frames + n_eval} "
        f"renders of {n_gauss_gt} Gaussians, {gt_dropped} pairs dropped")

    # kp_budget ~ a real SuperPoint per-frame detection count: the blobby
    # score maps put ~25 px over the key-primitive threshold per landmark,
    # and every kp-inserted point is prune-protected — the default 16384
    # budget would protect ~590k points across 36 keyframes and densify
    # would run away (the JAX package observed 639k alive by iter 840)
    cfg = MappingConfig(width=W, height=H, fx=fx, fy=fy, cx=cx, cy=cy,
                        kp_budget=2048)

    def new_trainer():
        return MappingTrainer(cfg, capacity=capacity,
                              frame_capacity=max(n_frames, 8), seed=seed,
                              device=dev)
    trainer = new_trainer()

    resumed = False
    if os.path.exists(ckpt_path):
        try:
            trainer = checkpoint.load(trainer, ckpt_path)
            # re-tier the active-set cap to the restored alive count (the
            # freshly-constructed trainer tiered it for an empty scene;
            # evaluating 150k alive under a 77k cap would drop visibles)
            trainer._refresh_visible_cap()
            if trainer.iteration >= map_iters:
                resumed = True
                log(f"RESUMED mapping state from {ckpt_path} "
                    f"(iter {trainer.iteration}, "
                    f"{int(trainer.scene.num_alive)} alive) — skipping "
                    "the mapping phase")
        except Exception as e:      # stale/incompatible checkpoint
            log(f"checkpoint {ckpt_path} not resumable ({e}); remapping")
            trainer = new_trainer()

    if not resumed:
        log("mapping: incremental keyframe insertion + windowed steps")
        # incremental: insert each keyframe, short map bursts (do_recon)
        per_kf = max(map_iters // (4 * n_frames), 2)
        t_map = time.perf_counter()
        for i, (img, dep, sc, w2c) in enumerate(frames):
            trainer.add_keyframe(img, dep, sc, w2c)
            trainer.map(per_kf)
            if i % 6 == 0:
                log(f"kf {i + 1}/{n_frames}, iter {trainer.iteration}")
        # global phase: remaining budget over all keyframes (crosses the
        # 2001 opacity reset and ~14 densify/prune cycles)
        if trace_evals:
            trace(trainer)
        while trainer.iteration < map_iters:
            trainer.map(min(300, map_iters - trainer.iteration))
            _synced(dev)
            log(f"iter {trainer.iteration}/{map_iters}, "
                f"alive {int(trainer.scene.num_alive)}")
            if trace_evals:
                trace(trainer)
        _synced(dev)
        dt_map = time.perf_counter() - t_map
        seconds["mapping"] = dt_map
        iters_per_s = trainer.iteration / dt_map
        checkpoint.save(trainer, ckpt_path)
        progress({"phase": "mapping", "iters": trainer.iteration,
                  "alive": int(trainer.scene.num_alive),
                  "iters_per_s": round(iters_per_s, 2),
                  "n_dropped_total": trainer.n_dropped_total,
                  "wall_s": round(dt_map, 0), "ckpt": ckpt_path})
        log(f"mapping state checkpointed -> {ckpt_path}")
    else:
        iters_per_s = 0.0   # not re-measured on resume; the log has the row
        for line in open(log_path) if os.path.exists(log_path) else []:
            try:
                row = json.loads(line)
                if row.get("phase") == "mapping":
                    iters_per_s = float(row.get("iters_per_s", 0.0))
            except (ValueError, TypeError, AttributeError):
                pass        # a torn or foreign line
    n_alive = int(trainer.scene.num_alive)
    # steps since the last densify check: their drop counters are on the
    # device still (one read, not counted in n_dropped_total)
    tail_dropped = (int(torch.stack(trainer._pending_dropped)[:, 0].sum())
                    if trainer._pending_dropped else 0)
    log(f"mapping done: iter {trainer.iteration}, {n_alive} alive, "
        f"{trainer.n_dropped_total} pairs ever dropped, {tail_dropped} "
        f"since the last check")

    log("evaluating held-out views")
    t0 = time.perf_counter()
    psnrs, ssims, contrasts = [], [], []
    for vi, view in enumerate(evals):
        p, q, c = score_views(trainer, [view], cam0)
        psnrs += p
        ssims += q
        contrasts += [x for x in c if x is not None]
        # partial results land as they compute: a lost run mid-eval leaves
        # per-view evidence on disk
        progress({"phase": "eval_view", "view": vi,
                  "psnr": round(psnrs[-1], 2), "ssim": round(ssims[-1], 3),
                  "kp_contrast": (round(contrasts[-1], 1) if contrasts
                                  else None)})
    seconds["eval"] = time.perf_counter() - t0

    res = {
        "psnr": round(float(np.mean(psnrs)), 2),
        "ssim": round(float(np.mean(ssims)), 3),
        "kp_contrast": round(float(np.mean(contrasts)), 1),
        "n_alive": n_alive,
        "iters": trainer.iteration,
        "iters_per_s": round(iters_per_s, 2),
        "n_dropped_total": trainer.n_dropped_total,
        "wall_s": round(time.perf_counter() - t_all, 0),
        "resumed": resumed,
    }
    progress({"phase": "final", **res})
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    if peak is not None:
        log(f"peak device memory {peak:.2f} GiB")
    return GateRun(result=res, trainer=trainer, evals=evals, cam0=cam0,
                   seconds=seconds, gt_dropped=gt_dropped,
                   tail_dropped=tail_dropped, peak_mem_gb=peak)


def main(n_frames: int = 36, n_eval: int = 4, map_iters: int = 2200,
         n_gauss_gt: int = 60_000, seed: int = 0, W: int = 640, H: int = 480,
         capacity: int = 205_440, device="cuda",
         trace_evals: bool = False) -> dict:
    res = run(n_frames=n_frames, n_eval=n_eval, map_iters=map_iters,
              n_gauss_gt=n_gauss_gt, seed=seed, W=W, H=H, capacity=capacity,
              device=device, trace_evals=trace_evals).result
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("map_iters", type=int, nargs="?", default=2200)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--trace-evals", action="store_true",
                    help="also score the held-out views every 300 "
                         "iterations of the global phase")
    args = ap.parse_args()
    main(map_iters=args.map_iters, device=args.device,
         trace_evals=args.trace_evals)
