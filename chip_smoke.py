"""Drive the PyTorch/CUDA port (``splatloc_tpu_torch``) on one NVIDIA GPU.

The quickest proof that the port starts on the card. It drives the port's
main paths through the entry points a user calls: serving the
forward render of a Gaussian map (``raster.render``) at the size of the JAX
package's bench scene, 100,000 Gaussians with C = 4 channels (RGB plus
kp_score), SH degree 0, seen through the Replica calibration (640x480,
configs/replica/base_config.yaml); the mapping trainer
(``train.mapping.MappingTrainer``) on that configuration, at its full width
and its CLI's capacity of 2^19 Gaussians; localization of query images
through ``cli/test.py``'s ``EvalSession`` (descriptor field, 2D-3D
matching, PnP and render-loss pose refinement); the mapping CLI
(``cli/train_gaussians.py``) from a dataset on disk to a saved map that
``EvalSession`` localizes from; the offline protocol from RGB-D frames
to a replay through every CLI; the multi-GPU layer's sharded render
and mapping step, with every rank on the card; and the reference-scale
tools: the full-scale quality gate, the refinement basin table and the
query path's rehearsal at the size of a real scene; and the benchmark and
profiling programs.
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
11. localize queries localized through ``cli/test.py``'s ``EvalSession``
             on room_0's configuration (640x480, decoder 4 x 128 -> 256,
             16-level hash grid at 2^19): phase 9's room of 100,000 splats
             inside room_0's bound with a tenth of them as key Gaussians,
             a decoder from ``--seed``, and a Replica-format dataset
             rendered from the map (8 database frames, 8 queries 3-10 cm
             and 1-3 deg off, score maps, a retrieval table, query
             features from the decoder plus noise); ``eval_pose`` with
             render-loss refinement, ``eval_rendering`` and
             ``eval_selection``, with the launch counts set to 0 just
             before and read just after; every query must solve, the
             medians stay under LOC_LIMITS and refinement no worse than
             PnP; the three kernels against their plain versions on the
             last query's refinement view; query 0 on the card against the
             CPU path, with the host syncs of its auction counted (none
             in a round, one per block of 20 rounds, one final read);
             per-stage times, a profile of one query and
             ``superpoint.extract``'s time
12. map      ``python -m splatloc_tpu_torch.cli.train_gaussians`` (its
             ``main``) on phase 11's dataset: room_0's configuration at
             640x480 and the CLI's capacity 2^19, the loader's 8 kept
             Sequence_1 frames as keyframes x 10 mapping iterations, 200
             colour-refinement iterations, a device trace of a steady
             keyframe's block (its idle share against the untraced steady
             step), with the launch counts set to 0 just before and read
             just after; metrics.jsonl, the losses, the saved map (a load
             and save gives the same bytes) and the trace are checked;
             ``EvalSession`` renders the query views from the learned map
             and localizes the queries from it; the three kernels against
             their plain versions on query 0's view of the learned map;
             the tiled blend (``use_pallas=False``) against the pair
             kernels on tests/test_pallas.py's scene and on that view,
             with the per-pixel oracle at any pixel past the limits
13. protocol the offline protocol on phase 11's frames through every
             CLI's ``main``, with the launch counts set to 0 just before
             and read just after: random SuperPoint and NetVLAD (64
             clusters, 4096-d whitening) weights from ``--seed``;
             ``preprocess`` extract-features, gen-retrieval and gen-fusion
             (``--voxel_size 0.02``) into a fresh generated folder;
             ``train_gaussians`` with phase 12's cut; ``train_decoder`` at
             room_0's full decoder width for 3 of the CLI's 41 epochs;
             ``test
             --eval_pose --eval_rendering --eval_selection --save_pose
             --save_match``; ``replay``. Every artifact must exist and
             parse, the medians be finite, PSNR above 10 dB and the
             decoder's loss fall; each stage on one input against the CPU
             path (NetVLAD, the retrieval table, one frame's TSDF volume,
             fused features, one decoder step's gradients); the three
             kernels against their plain versions on the learned map; a
             decoder step's wall, syncs and device profile, and encode's
             forward and backward in its one-gather form against the
             per-level form; two decoder runs bit for bit; and a decoder
             fit: trained on the fused points labelled by phase 11's
             decoder, it localizes phase 11's queries

14. dist     the multi-GPU layer (``dist``), every rank on the card: the
             kernels built first, then groups of 2 and of 4 ranks spawned
             with ``torch.multiprocessing`` over gloo (nccl refuses two
             ranks on one device; nccl runs as well where each rank has a
             card of its own). (a) serve view 0 through
             ``rasterize_sharded`` on a tile mesh of every rank, forward
             and backward: image and depth bit-identical to the
             single-process render, nothing dropped, the grads of means,
             opacities and colors within 1e-6 relative L2; (b) in the
             group of 4, ``make_sharded_mapping_step`` on a (data=2,
             gauss=2) mesh at phase 9's configuration (capacity 2^19, a
             window of 5 keyframes of the room) against the unsharded
             step (loss rtol 1e-5, xyz atol 1e-5), and two runs bit for
             bit. Each rank's launch counts are set to 0 just before its
             runs and read just after; it prints its pairs, walls,
             collectives with their bytes and host syncs
15. gate     ``python -m splatloc_tpu_torch.tools.quality_gate`` (its
             ``run``) at full width: 36 RGB-D keyframes at 640x480
             rendered from a 60,000-Gaussian ground truth through the
             tiled blend, incremental insertion and windowed 5-view steps
             to GATE_SMOKE_ITERS of the tool's 2,200 iterations (8
             densify/prune cycles), capacity 205,440, kp_budget 2,048,
             4 held-out views scored on the pair kernels, with fresh
             progress and checkpoint paths and the launch counts set to 0
             just before and read just after: 5 launches of each kernel a
             step and one forward a held-out view; the scores at or above
             GATE_BARS; every drop counted, none after the last check and
             none in the held-out renders; the three kernels against
             their plain versions on the last held-out view
16. table    ``python -m splatloc_tpu_torch.tools.refine_table`` with
             TABLE_SEEDS seed a row (160x120, 500 Gaussians, six start
             errors from 1 cm / 1 deg to 15 cm / 12 deg, refine_pose on
             the pair kernels), the launch counts set to 0 just before and
             read just after: every row's median final error within
             LOC_LIMITS (5 mm, 0.1 deg); the three kernels against their
             plain versions on the table's scene
17. rehearsal ``python -m splatloc_tpu_torch.tools.eval_rehearsal`` (its
             ``run``) at full width: 110,000 Gaussians, 100 database views
             rendered at 640x480 on the pair kernels, 5,000 of 30,000 key
             Gaussians selected as landmarks, SuperPoint at 4,096 key
             points (random weights), frustum points padded to 4,096 and
             decoded, the 4,096 x 4,096 auction, PnP on 512 matches x 256
             hypotheses, 3 refinements of 64 iterations a level on
             110,000 Gaussians; REHEARSAL_SMOKE_QUERIES of the tool's 100
             queries, the launch counts set to 0 just before and read just
             after. The result has the JAX tool's keys and finite stage
             medians; 5,000 landmarks; every query reaches PnP and none
             raises; the launches are exactly what the refinements'
             records imply (one forward a database render, a target, a
             seed, an iteration and each of the guard's two; a backward
             and a reduction an iteration); the three kernels against
             their plain versions on database view 0; query 0's SuperPoint
             and padded decode against the CPU path
             (REHEARSAL_CPU_LIMITS). Reports the solved count, the
             database renders' drops, query 0's auction (rounds,
             unconverged rows, syncs, device busy and idle share), PnP's
             device memory and the run's peak device memory
18. bench    the benchmark and profiling tools
             (``splatloc_tpu_torch.tools.{bench,bench_pose,bench_refine,
             profile_bench,profile_chain,profile_map}``, the counterparts
             of ``bench.py``, ``bench_pose.py``,
             ``tools/bench_refine.py`` and ``tools/profile_*.py``) through
             their ``run``/``main`` at full width, each with the launch
             counts set to 0 just before and read just after: bench's stages A (320x240, 30,000), B and C
             (640x480, 100,000; C with probe-sized caps) at 100 gradient
             steps each, bench_pose's 50 twist steps, bench_refine's
             refinement from 5 cm / 5 deg (1 of its 5 seeds), profile_bench
             and profile_chain at PROFILE_ITERS steps, profile_map's trainer
             at 130,000 alive for 1 + 6 + 6 steps. Each line has the JAX
             program's keys and finite numbers; bench's stages drop no pair;
             the launches are exactly each tool's renders; the three kernels
             against their plain versions on profile_map's last keyframe
             view (random-depth keyframes and the random fill); a 64x48
             bench step on the card against the CPU path
             (BENCH_CPU_LIMITS). Reports the lines, bench's stages, the
             drops at default caps of bench_pose's and bench_refine's
             targets and profile_map's keyframe views, and profile_chain's
             device busy and idle ms with its largest gaps
19. pnp      the benchmark's localize traffic (``portbench``, cell
             ``localize.replica_room0``) at each of PNP_SEEDS: its set-up,
             then its 100 queries once each through the Localizer, whose
             RANSAC solve runs the Gauss-Newton kernel
             (``csrc/pnp_refine.cu``), launch counts set to 0 just before
             and read just after each query; the plain version's solve on
             the inputs and draws the Localizer's solve recorded. Exactly
             two launches a solve; on every query the same winning
             hypothesis, the same inliers and count and the pose within
             PNP_LIMITS (a query that differs fails the phase, its pose
             gaps against the benchmark's reference in the message).
             Reports the Localizer's PnP stage ms beside the plain solve's,
             and on the query with the most pairs the two launches' device
             ms beside their bound and the plain fits' ms

Prints a ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
its last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is not 0 and no result line is printed.

Run from the repository root:  python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from splatloc_tpu_torch import build
from splatloc_tpu_torch.cli.config import load_config
from splatloc_tpu_torch.core import sh, transforms
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.match import pnp
from splatloc_tpu_torch.raster import binning, hopper_raster, pairs, project
from splatloc_tpu_torch.raster import RasterConfig, render
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train import checkpoint
from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer
from splatloc_tpu_torch.utils.profiling import count_syncs

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


def make_room_scene(n: int, seed: int, device, half_w: float = 3.0,
                    half_h: float = 2.0, depth: float = 8.0) -> GaussianScene:
    """A room for the trainer's keyframes: ``n`` flat splats (3-5 cm across,
    2.5 mm thick) on the back wall, side walls, floor and ceiling of a
    2 half_w x 2 half_h x depth box (6 x 4 x 8 m), the camera inside at the
    origin facing the back wall, opacities in [0.6, 0.95], channels in
    [0, 1]. Its rendered depth is a surface's, as a depth sensor reports
    it; the bench scene's random volume renders a depth that jumps by
    metres between neighbouring pixels, so the keyframe initialisation
    would size its splats tens of tiles wide and overflow the binning's
    tile caps."""
    rng = np.random.default_rng(seed + 3)
    w, h, d = half_w, half_h, depth
    # (axis of the normal, its coordinate, ranges of the other two axes)
    walls = [(2, d, (-w, w), (-h, h)),
             (0, -w, (-h, h), (0, d)), (0, w, (-h, h), (0, d)),
             (1, -h, (-w, w), (0, d)), (1, h, (-w, w), (0, d))]
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


def profile(fn, wall_ms: float, reps: int, warm: bool = False) -> dict:
    """Where the time of one call of ``fn`` goes: torch.profiler over
    ``reps`` calls after a warm-up call (none when ``warm``: ``fn`` has
    run already). Device busy is the summed time of the device-side events
    (kernels, copies, fills) per call; the idle share is the rest of
    ``wall_ms``, the unprofiled time of one call (the profiler itself slows
    the host). A warm ``fn`` is traced on the device alone: a query's
    quarter of a million host ops take the profiler minutes to sort."""
    from torch.profiler import ProfilerActivity
    if not warm:
        fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] if warm else [ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
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


# the raster path's kernels; read_launches adds PnP's Gauss-Newton kernel
RASTER_KERNELS = ("fwd_pairwalk", "bwd_pairwalk", "seg_reduce")


def _launchers() -> dict:
    return {**{k: getattr(hopper_raster, k) for k in RASTER_KERNELS},
            "pnp_refine": pnp.gauss_newton_fit}


def reset_launches() -> None:
    for k in _launchers().values():
        k.launches = 0


def read_launches() -> dict:
    return {name: k.launches for name, k in _launchers().items()}


def raster_only(n: int) -> dict:
    """The launch counts of a path that runs ``n`` of each raster kernel
    and no PnP."""
    return {**dict.fromkeys(RASTER_KERNELS, n), "pnp_refine": 0}


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
    if launches != raster_only(want):
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


# --------------------------------------------------------------------------
# phase 11: localization through cli/test.py's EvalSession
# --------------------------------------------------------------------------

LOCALIZE_CONFIG = REPO / "configs" / "replica" / "room_0.yaml"
N_SEQ1_FRAMES = 40      # Sequence_1; the Replica loader keeps every 5th
N_QUERIES = 8
KEY_FRACTION = 0.1      # ~10,000 of the map's splats are key Gaussians
MAX_QUERY_KP = 4096
QUERY_PX_NOISE = 0.5
# per component of a unit 256-vector: a norm of 0.32, cosine ~0.95
DESC_NOISE = 0.02
LANDMARK_NUM = 5000
# the phase 9 room shrunk to 4.4 x 2.8 x 7.6 m and turned so its depth
# runs along x and its height along z: inside room_0's bound (x -1..7,
# y -1.3..3.7, z -1.7..1.4; configs/replica/room_0.yaml)
ROOM_BOX = dict(half_w=2.2, half_h=1.4, depth=7.6)
ROOM_TO_WORLD_R = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
ROOM_TO_WORLD_T = np.array([-0.8, 1.2, -0.15], np.float32)
# the pair path (the three kernels), which refinement takes on the card
PAIR_CFG = RasterConfig(use_pallas=True)
# limits of the phase, from a CPU rehearsal of it (160x120, 20,000 splats,
# two queries: refined medians 1.6 mm and 0.028 deg, PnP's 2.4 mm and
# 0.42 deg), about three times the refined medians there
LOC_LIMITS = {"match_median_t_m": 0.005, "match_median_r_deg": 0.1}
# the card against the port's CPU path on one query: decode rounds its MLP
# operands to bf16 after float32 sums taken in another order (a sum one
# ulp apart can round to the next bf16 value); the similarity is a 256-term
# float32 dot product; the auction runs on one similarity matrix on both
# (elementwise arithmetic and maxima only: exact); PnP's SVDs and solves
# differ in rounding
CARD_CPU_LIMITS = {"decode": 1e-4, "sim": 1e-6, "pnp_r": 1e-4,
                   "pnp_t": 1e-4}


def room0_scene(n: int, seed: int, device) -> GaussianScene:
    """Phase 9's room (``make_room_scene``) inside room_0's bound, with a
    seeded tenth of its splats as key Gaussians (marker 0.9, the rest 0)."""
    room = make_room_scene(n, seed, device, **ROOM_BOX)
    R = torch.from_numpy(ROOM_TO_WORLD_R).to(device)
    t = torch.from_numpy(ROOM_TO_WORLD_T).to(device)
    # the room's splats are axis-aligned (identity quaternions): turned,
    # each carries the turn's quaternion
    q = transforms.matrix_to_quat(R)
    key = np.random.default_rng(seed + 11).random(n) < KEY_FRACTION
    return room.replace(
        xyz=room.xyz @ R.T + t, rotation=q.expand(n, 4).contiguous(),
        marker=torch.from_numpy(np.where(key, 0.9, 0.0).astype(
            np.float32)[:, None]).to(device))


def room_to_world(c2w_room: np.ndarray) -> np.ndarray:
    T = np.eye(4, dtype=np.float64)
    T[:3, :3], T[:3, 3] = ROOM_TO_WORLD_R, ROOM_TO_WORLD_T
    return T @ c2w_room


def seq1_poses(n: int) -> np.ndarray:
    """World c2w [n, 4, 4] along a path inside the room: 0.8 m sideways,
    0.3 m forward, a yaw sweep of +-11 deg, a slow bob."""
    out = []
    for i in range(n):
        s = i / max(n - 1, 1)
        a = -0.2 + 0.4 * s
        c2w = np.eye(4)
        c2w[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        c2w[:3, 3] = [-0.4 + 0.8 * s, 0.1 * np.sin(i / 6.0), 0.3 + 0.3 * s]
        out.append(room_to_world(c2w))
    return np.stack(out)


def query_poses(db_c2w: np.ndarray, n: int, seed: int) -> np.ndarray:
    """Query ``q`` 3-10 cm and 1-3 deg from database pose ``q % len``
    (a seeded direction and axis in the camera frame)."""
    rng = np.random.default_rng(seed + 12)
    out = []
    for q in range(n):
        d = rng.normal(size=3)
        ax = rng.normal(size=3)
        xi = np.concatenate([d / np.linalg.norm(d) * rng.uniform(0.03, 0.10),
                             ax / np.linalg.norm(ax)
                             * np.radians(rng.uniform(1.0, 3.0))])
        delta = np.linalg.inv(transforms.se3_exp(
            torch.tensor(xi, dtype=torch.float64)).numpy())
        # se3_exp's translation is V rho; place the centre exactly
        delta[:3, 3] = xi[:3]
        out.append(db_c2w[q % len(db_c2w)] @ delta)
    return np.stack(out)


def render_rgbd(scene, cam) -> tuple[np.ndarray, np.ndarray]:
    """(RGB uint8 [H,W,3], depth uint16 mm [H,W]) of one view, as a sensor
    gives them: depth is the rendered expected depth over alpha where
    alpha > 0.5, else 0."""
    with torch.no_grad():
        out = render(scene, cam, RasterConfig(use_pallas=True))
    rgb = (out["render"].clamp(0, 1) * 255).to(torch.uint8).cpu().numpy()
    alpha = out["opacity"]
    depth = torch.where(alpha > 0.5, out["depth"] / alpha.clamp_min(0.5),
                        torch.zeros_like(alpha))
    mm = (depth * 1000).clamp(0, 65535).to(torch.int32).cpu().numpy()
    return rgb, mm.astype(np.uint16)


def visible_keys(scene, cam, key_idx) -> tuple[np.ndarray, np.ndarray]:
    """(indices into key_idx, pixel coords) of the key Gaussians in the
    view (z > 0.2, inside the image), on the rasterizer's pixel grid, as
    data/synthetic.py projects its landmarks. The room is a convex box
    seen from inside: nothing in the frustum is hidden."""
    uv, z = cam.project(scene.xyz[key_idx])
    uv, z = uv.cpu().numpy(), z.cpu().numpy()
    ok = ((z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
          & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
    return np.nonzero(ok)[0], uv[ok]


def write_replica_dataset(config, scene, decoder_params, field_cfg, seed,
                          device, n_queries: int = N_QUERIES) -> dict:
    """The Replica-format dataset the session loads: Sequence_1 (rendered
    RGB-D, traj_w_c.txt), score maps of the key Gaussians in each kept
    database frame (0.9 at their rounded projections, data/synthetic.py:
    104-112), Sequence_2 queries, netvlad_retrieval.txt (nearest database
    pose first, synthetic.py:132-142) and query_features/<name>.npz (the
    visible key Gaussians' projections, at most MAX_QUERY_KP, with 0.5 px
    of noise; their decoder descriptors plus noise, re-normalised)."""
    from PIL import Image
    from splatloc_tpu_torch.fields import decode

    ds_dir = Path(config["Dataset"]["dataset_path"])
    gen = Path(config["Dataset"]["generated_folder"]) / ds_dir.name
    for d in ("Sequence_1/rgb", "Sequence_1/depth", "Sequence_2/rgb",
              "Sequence_2/depth"):
        (ds_dir / d).mkdir(parents=True, exist_ok=True)
    for d in ("score_map", "query_features"):
        (gen / d).mkdir(parents=True, exist_ok=True)
    cal = config["Dataset"]["Calibration"]
    base = Camera.create(np.eye(4, dtype=np.float32), cal["fx"], cal["fy"],
                         cal["cx"], cal["cy"], cal["width"], cal["height"],
                         device=device)
    key_idx = torch.nonzero(scene.marker[:, 0] > 0.005)[:, 0]
    rng = np.random.default_rng(seed + 13)

    def cam_of(c2w):
        return base.replace_pose(torch.from_numpy(
            np.linalg.inv(c2w).astype(np.float32)))

    seq1 = seq1_poses(N_SEQ1_FRAMES)
    for i, c2w in enumerate(seq1):
        cam = cam_of(c2w)
        rgb, mm = render_rgbd(scene, cam)
        Image.fromarray(rgb).save(ds_dir / "Sequence_1/rgb" / f"rgb_{i}.png")
        Image.fromarray(mm).save(ds_dir / "Sequence_1/depth"
                                 / f"depth_{i}.png")
        if i % 5 == 0:
            _, uv = visible_keys(scene, cam, key_idx)
            score = np.zeros((cal["height"], cal["width"]), np.float32)
            ui, vi = np.round(uv[:, 0]).astype(int), np.round(uv[:, 1]).astype(
                int)
            ok = (ui < cal["width"]) & (vi < cal["height"])
            score[vi[ok], ui[ok]] = 0.9
            np.save(gen / "score_map" / f"rgb_{i}_score.npy", score)
    np.savetxt(ds_dir / "Sequence_1/traj_w_c.txt", seq1.reshape(-1, 16))

    kept = seq1[::5]
    queries = query_poses(kept, n_queries, seed)
    lines = []
    for q, c2w in enumerate(queries):
        cam = cam_of(c2w)
        rgb, mm = render_rgbd(scene, cam)
        Image.fromarray(rgb).save(ds_dir / "Sequence_2/rgb" / f"rgb_{q}.png")
        Image.fromarray(mm).save(ds_dir / "Sequence_2/depth"
                                 / f"depth_{q}.png")
        sel, uv = visible_keys(scene, cam, key_idx)
        if len(sel) > MAX_QUERY_KP:
            pick = np.sort(rng.choice(len(sel), MAX_QUERY_KP, replace=False))
            sel, uv = sel[pick], uv[pick]
        uv = uv + rng.normal(0, QUERY_PX_NOISE, uv.shape)
        with torch.no_grad():
            desc = decode(decoder_params, scene.xyz[key_idx[torch.from_numpy(
                sel).to(device)]], field_cfg).cpu().numpy()
        desc = desc + rng.normal(0, DESC_NOISE, desc.shape)
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        np.savez(gen / "query_features" / f"rgb_{q}.npz",
                 keypoints=uv.astype(np.float32),
                 descriptors=desc.T.astype(np.float32))
        d = [np.linalg.norm(c2w[:3, 3] - k[:3, 3])
             + np.abs(c2w[:3, :3] - k[:3, :3]).sum() * 0.1 for k in kept]
        lines.append(f"rgb_{q} " + " ".join(f"rgb_{5 * j}"
                                            for j in np.argsort(d)[:5]))
    np.savetxt(ds_dir / "Sequence_2/traj_w_c.txt", queries.reshape(-1, 16))
    (gen / "netvlad_retrieval.txt").write_text("\n".join(lines) + "\n")
    return {"db_frames": len(kept), "queries": len(queries)}


def localize_config(tmp: str, changes: dict | None = None) -> dict:
    """room_0's configuration (the port's load_config) with the dataset,
    generated folder and results under ``tmp``; ``changes`` replace
    calibration fields (a CPU rehearsal's smaller image)."""
    config = load_config(str(LOCALIZE_CONFIG))
    config["Dataset"]["dataset_path"] = str(Path(tmp) / "replica" / "room_0")
    config["Dataset"]["generated_folder"] = str(Path(tmp) / "generated")
    config["Results"]["save_dir"] = str(Path(tmp) / "results")
    config["Dataset"]["Calibration"].update(changes or {})
    return config


def card_cpu_check(session, seed: int) -> dict:
    """Query 0 on the card against the port's CPU path: decode of its
    database points, the similarity matrix, the auction on one similarity
    matrix (its first 512 query rows: the whole auction on the host CPU
    takes minutes, hundreds of rounds over a 4,096 x 6,664 matrix), and
    PnP with one
    set of injected priorities on all its matches (1,024 hypotheses)."""
    from splatloc_tpu_torch.fields import decode
    from splatloc_tpu_torch.match import hungarian, pnp

    loc = session.make_localizer()
    ds = session.train_dataset
    name = session.test_dataset.index_to_name(0)
    db_frame = ds.get_frame(ds.name_to_index(loc.retrieval_table[name][0]))
    pts3d, feats, _ = loc.get_frustum_points(db_frame)
    cpu_params = {"table": session.decoder_params["table"].cpu(),
                  "layers": [w.cpu() for w in
                             session.decoder_params["layers"]]}
    pts = torch.from_numpy(np.asarray(pts3d, np.float32))
    feats_cpu = decode(cpu_params, pts, session.field_cfg)
    res = {"points": int(pts.shape[0]),
           "decode": float((feats.cpu() - feats_cpu).abs().max())}
    qf = loc.query_features(name)
    q = torch.from_numpy(qf["descriptors"])
    sim_cpu = hungarian._sim_matrix(q, feats_cpu.T, loc.sim_thresh)
    sim_card = hungarian._sim_matrix(q.cuda(), feats_cpu.T.cuda(),
                                     loc.sim_thresh)
    res["sim"] = float((sim_card.cpu() - sim_cpu).abs().max())
    sub = sim_cpu[:512]
    a_cpu = hungarian.auction_assignment(sub, eps=1e-4)
    a_card = hungarian.auction_assignment(sub.cuda(), eps=1e-4)
    res["auction_rows"] = int(sub.shape[0])
    res["auction_same"] = bool(torch.equal(a_card.cpu(), a_cpu))
    res["auction_syncs"] = auction_syncs(sim_card)
    # the matches of the query as the card makes them (the whole auction on
    # the host CPU would take minutes)
    matches, _ = hungarian.hungarian_solve(qf["descriptors"], feats.T,
                                           device="cuda")
    q2d = qf["keypoints"][matches[0]].astype(np.float32)
    p3d = np.asarray(pts3d, np.float32)[matches[1]]
    g = torch.Generator().manual_seed(seed)
    pri = torch.rand((1024, matches.shape[1]), generator=g)
    r_cpu = pnp.solve_pnp_ransac(q2d, p3d, session.eval_K,
                                 inlier_px=session.inlier_px, priorities=pri,
                                 device="cpu")
    r_card = pnp.solve_pnp_ransac(q2d, p3d, session.eval_K,
                                  inlier_px=session.inlier_px, priorities=pri,
                                  device="cuda")
    res["pnp_matches"] = int(matches.shape[1])
    res["pnp_inliers"] = (r_card["num_inliers"], r_cpu["num_inliers"])
    res["pnp_r"] = float(np.abs(r_card["r"] - r_cpu["r"]).max())
    res["pnp_t"] = float(np.abs(r_card["t"] - r_cpu["t"]).max())
    log("localize: query 0 on the card vs the CPU path " + json.dumps(res)
        + f" (limits {json.dumps(CARD_CPU_LIMITS)})")
    bad = [k for k, lim in CARD_CPU_LIMITS.items() if not res[k] <= lim]
    if (bad or not res["auction_same"]
            or res["pnp_inliers"][0] != res["pnp_inliers"][1]):
        raise AssertionError(f"card and CPU path differ on query 0: {res}")
    sy = res["auction_syncs"]
    if not (sy["round"] == 0 and sy["auction"] == sy["blocks"]
            and sy["read"] == 1):
        raise AssertionError(f"the auction syncs more than once a block of "
                             f"rounds plus the final read: {sy}")
    return res


def auction_syncs(sim) -> dict:
    """The host syncs of the auction on one similarity matrix on the card:
    one round (none: no mask index), the whole auction_assignment (one read
    of the unassigned count per block of 20 rounds) and the final read of
    the assignment, beside the rounds that same run made (counted by
    wrapping its round function) and its wall time."""
    from splatloc_tpu_torch.match import hungarian
    if sim.shape[0] > sim.shape[1]:
        sim = sim.T.contiguous()
    R, C = sim.shape
    state = (torch.zeros((C,), device=sim.device),
             torch.full((C,), -1, dtype=torch.int32, device=sim.device),
             torch.full((R,), -1, dtype=torch.int32, device=sim.device))
    one_round = hungarian._auction_round
    _, n_round = count_syncs(lambda: one_round(sim, *state, 1e-4))
    rounds = [0]

    def counted(*a):
        rounds[0] += 1
        return one_round(*a)
    hungarian._auction_round = counted
    try:
        t0 = time.perf_counter()
        got, n_auction = count_syncs(lambda: hungarian.auction_assignment(
            sim, eps=1e-4))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        hungarian._auction_round = one_round
    _, n_read = count_syncs(lambda: got.cpu())
    return {"matrix": [R, C], "rounds": rounds[0],
            "blocks": -(-rounds[0] // 20), "round": n_round,
            "auction": n_auction, "read": n_read, "auction_ms": ms,
            "unconverged": int((got < 0).sum())}


def localize_phase(seed: int, device, card: str, n: int = N_GAUSSIANS,
                   calib: dict | None = None,
                   landmark_num: int = LANDMARK_NUM,
                   n_queries: int = N_QUERIES) -> dict:
    """Phase 11: queries localized through cli/test.py's EvalSession on
    room_0's configuration (eval_pose with render-loss refinement, then
    eval_rendering and eval_selection), with every kernel's launch count
    set to 0 just before and read just after."""
    from splatloc_tpu_torch.cli.test import EvalSession
    from splatloc_tpu_torch.cli.config import save_dir_for
    from splatloc_tpu_torch.eval import metrics
    from splatloc_tpu_torch.fields import FeatureFieldConfig, init_decoder
    from splatloc_tpu_torch.match.localize import _level_cam_gt
    from splatloc_tpu_torch.train.decoder_train import save_params

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="splatloc_localize_")
    config = localize_config(tmp, calib)
    save_dir = save_dir_for(config)
    scene = room0_scene(n, seed, device)
    ply.save_scene(scene, str(Path(save_dir) / "point_cloud" / "final"
                              / "point_cloud.ply"))
    field_cfg = FeatureFieldConfig.from_config(config)
    params = init_decoder(field_cfg, torch.Generator(device).manual_seed(seed),
                          device=device)
    save_params(params, str(Path(save_dir) / "train_feat" / "ckpt.npz"))
    made = write_replica_dataset(config, scene, params, field_cfg, seed,
                                 device, n_queries)
    g = field_cfg.grid_config
    log(f"localize: room_0 config {config['Dataset']['Calibration']['width']}"
        f"x{config['Dataset']['Calibration']['height']}, fx "
        f"{config['Dataset']['Calibration']['fx']}; decoder "
        f"{field_cfg.num_layers} x {field_cfg.hidden_dim} -> "
        f"{field_cfg.final_dim}, hash grid {g.n_levels} x 2^"
        f"{g.log2_hashmap_size} (resolutions {g.resolutions[0]}-"
        f"{g.resolutions[-1]}); map {n} splats, "
        f"{int((scene.marker > 0.005).sum())} key; {json.dumps(made)}; "
        f"set-up {time.perf_counter() - t_phase:.1f} s")

    session = EvalSession(config, save_dir, refine_with_render_loss=True,
                          device=device)
    scene_on = session.scene                  # the map as the session loaded it
    per_query = []

    def on_query(name, loc, retrieval_ret, match_ret, frame):
        rec = {"name": name, "success": bool(match_ret["success"]),
               "stages_ms": {k: v * 1e3 for k, v in loc.last_stages.items()},
               "retrieval_err": metrics.pose_errors(
                   retrieval_ret["r"], retrieval_ret["t"], frame["c2w"])}
        info = match_ret.get("refine_info")
        if info is not None:
            rec["pnp_err"] = metrics.pose_errors(
                match_ret["pnp_r"], match_ret["pnp_t"], frame["c2w"])
            rec["refine"] = {"seed_evals": info["seed_evals"],
                             "syncs": info["syncs"],
                             "guard_kept_start": info["guard_kept_start"],
                             "levels": info["levels"]}
            # the pair build's drop counters of each level's view at the
            # refined pose
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, :3], c2w[:3, 3] = match_ret["r"], match_ret["t"]
            ds = session.train_dataset
            cam1 = Camera.create(np.linalg.inv(c2w), ds.fx, ds.fy, ds.cx,
                                 ds.cy, ds.width, ds.height, device=device)
            gt = torch.zeros((ds.height, ds.width, 3), device=device)
            for lv in rec["refine"]["levels"]:
                cam_s, _ = _level_cam_gt(cam1, gt, lv["scale"])
                nd, nt, nv = drop_counters(scene_on, cam_s, PAIR_CFG)
                lv.update(n_dropped=nd, n_trunc=nt, n_vis_dropped=nv)
            rec["w2c"] = np.linalg.inv(c2w)
        rec["match_err"] = metrics.pose_errors(match_ret["r"], match_ret["t"],
                                               frame["c2w"])
        per_query.append(rec)
        log(f"localize: query {name} " + json.dumps(
            {k: v for k, v in rec.items() if k != "w2c"}))

    synced(device)
    reset_launches()
    t0 = time.perf_counter()
    m_t, m_r = session.eval_pose(on_query=on_query)
    synced(device)
    pose_s = time.perf_counter() - t0
    launches_pose = read_launches()
    report = (Path(save_dir) / "eval_pose.txt").read_text()
    t0 = time.perf_counter()
    rendering = session.eval_rendering()
    rendering_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sel_t, sel_r = session.eval_selection(landmark_num=landmark_num)
    synced(device)
    selection_s = time.perf_counter() - t0
    launches = read_launches()

    queries = per_query[:len(m_t)]
    solved = sum(r["success"] for r in queries)
    med = {k: [float(np.median([r[k][1] for r in queries])),
               float(np.median([r[k][0] for r in queries]))]
           for k in ("retrieval_err", "match_err")}
    med["pnp_err"] = [float(np.median([r["pnp_err"][1] for r in queries
                                       if "pnp_err" in r])),
                      float(np.median([r["pnp_err"][0] for r in queries
                                       if "pnp_err" in r]))]
    stages = {}
    for r in queries:
        for k, v in r["stages_ms"].items():
            stages.setdefault(k, []).append(v)
    res = {"queries": len(queries), "solved": solved,
           "median_m_deg": {"retrieval": med["retrieval_err"],
                            "pnp": med["pnp_err"],
                            "refined": med["match_err"]},
           "stage_ms_mean": {k: float(np.mean(v)) for k, v in stages.items()},
           "stage_ms_median": {k: float(np.median(v))
                               for k, v in stages.items()},
           "eval_pose_s": pose_s, "eval_rendering_s": rendering_s,
           "eval_selection_s": selection_s, "rendering": rendering,
           "selection_median_m_deg": [float(np.median(sel_t)),
                                      float(np.median(sel_r))],
           "launches_eval_pose": launches_pose, "launches": launches}
    log(f"localize on {card}: " + json.dumps(res))
    res["query0_total_ms"] = queries[0]["stages_ms"]["total"]
    log("localize: eval_pose.txt: " + report.replace("\n", " | "))
    if solved != len(queries) or len(queries) != n_queries:
        raise AssertionError(f"{solved} of {len(queries)} queries solved "
                             f"(expected {n_queries})")
    mt, mr = med["match_err"][0], med["match_err"][1]
    pt, pr = med["pnp_err"][0], med["pnp_err"][1]
    if not (mt <= LOC_LIMITS["match_median_t_m"]
            and mr <= LOC_LIMITS["match_median_r_deg"]):
        raise AssertionError(f"refined median {mt} m, {mr} deg past the "
                             f"limits {LOC_LIMITS}")
    if not (mt <= pt and mr <= pr):
        raise AssertionError(f"refined median ({mt} m, {mr} deg) worse than "
                             f"PnP's ({pt} m, {pr} deg)")
    if any(v < 1 for v in launches.values()):
        raise AssertionError(f"a kernel did not launch in the phase: "
                             f"{launches}")
    # every query solved, so every query ran one RANSAC solve: two fits
    if launches_pose["pnp_refine"] != 2 * len(per_query):
        raise AssertionError(f"eval_pose launched PnP's kernel "
                             f"{launches_pose['pnp_refine']} times for "
                             f"{len(per_query)} queries")

    # the kernels against their plain versions on the last query's
    # full-resolution refinement view (at its refined pose)
    ds = session.train_dataset
    last = [r for r in queries if "w2c" in r][-1]
    cam = Camera.create(last["w2c"], ds.fx, ds.fy, ds.cx, ds.cy, ds.width,
                        ds.height, device=device)
    with torch.no_grad():
        walk_args, C, pr0 = walk_inputs(scene_on, cam, PAIR_CFG)
        got = hopper_raster.fwd_pairwalk(*walk_args, C, PAIR_CFG)
        ref = hopper_raster.fwd_pairwalk_plain(*walk_args, C, PAIR_CFG)
        synced(device)
        mf = compare_walk(got, ref, C)
        _, _, _, errs = check_backward(walk_args, got, pr0, C, PAIR_CFG, seed,
                                       ds.width, ds.height)
    res["kernel_errs"] = {"fwd_pairwalk": mf["max_abs_err"], **errs}
    log("localize: kernels vs plain on the last query's refinement view "
        + json.dumps(res["kernel_errs"]))
    res["session"] = session
    res["tmp"] = tmp
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def localize_extras(session, res: dict, card: str) -> None:
    """Phase 11's measurements outside the counted run: the card against
    the CPU path on query 0, a torch.profiler breakdown of one query, and
    superpoint.extract's time on a frame of the configuration's size
    (random weights)."""
    from splatloc_tpu_torch.match import superpoint

    t0 = time.perf_counter()
    card_cpu_check(session, 0)
    log(f"localize: card vs CPU check {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loc = session.make_localizer()
    ds = session.test_dataset
    frame = ds.get_frame(0)
    name = ds.index_to_name(0)
    # the unprofiled wall time of this query is the counted run's, and the
    # counted run warmed it
    log("localize: profile of one query (refinement on): " + json.dumps(
        profile(lambda: loc.localize(frame, name),
                res["query0_total_ms"], 1, warm=True)))
    log(f"localize: profile {time.perf_counter() - t0:.1f} s")
    sp = superpoint.init_params(torch.Generator("cuda").manual_seed(0),
                                device="cuda")
    rgb = ds.load_image(0)
    gray = torch.as_tensor((0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                            + 0.114 * rgb[..., 2]).astype(np.float32),
                           device="cuda")
    ms = event_ms(lambda: superpoint.extract(sp, gray), 5, host_ahead=False)
    out = superpoint.extract(sp, gray)
    log(f"localize: superpoint.extract on {tuple(gray.shape)} (random "
        f"weights) {ms:.3f} ms host-paced on {card}, "
        f"{int(out['valid'].sum())} valid keypoints")
    res["superpoint_ms"] = ms


# --------------------------------------------------------------------------
# phase 12: the mapping CLI on phase 11's dataset
# --------------------------------------------------------------------------

MAP_REFINE_ITERS = 200  # of the CLI's 26,000 colour-refinement iterations
# the keyframe whose map() block is traced: a steady one, past keyframe
# 0's first use of the path and with no densify in its block
MAP_TRACE_KF = 3
# the JAX package's pair-vs-blend limits (tests/test_pallas.py:64-68),
# set there on colour channels in [0, 1]: the keypoint-score channel, a
# logit of a few units, is held to the same limit relative to its largest
# magnitude (its float32 sums round in proportion to it)
BLEND_PAIR_LIMITS = {"image": 5e-5, "kp_score": 5e-5, "depth": 2e-4,
                     "alpha": 5e-5}
# share of the learned map view's pixels allowed past those limits (a
# Gaussian at a cut blended by one path only; see blend_vs_pair)
BLEND_FLIP_SHARE = 1e-4
# relative nudges of a cut (alpha_min, transmittance_eps) under which the
# per-pixel oracle must reproduce each path at a pixel past the limits
CUT_NUDGES = (1e-5, 1e-3)


def trace_device_ms(trace_dir: Path) -> tuple[float, float, bool]:
    """(summed device time in ms of the one trace in ``trace_dir``, the ms
    from its first device event's start to its last one's end, whether it
    names a fwd_pairwalk launch)."""
    files = list(trace_dir.glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"expected one trace in {trace_dir}: {files}")
    events = [e for e in json.loads(files[0].read_text())["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e.get("dur", 0) for e in events)
    span = (max(e["ts"] + e.get("dur", 0) for e in events)
            - min(e["ts"] for e in events)) if events else float("nan")
    named = any("fwd_pairwalk" in str(e.get("name", "")) for e in events
                if e.get("cat") == "kernel")
    return busy / 1e3, span / 1e3, named


def blend_diff_maps(a, b, kp_scale: float) -> dict:
    """Per-pixel differences of two renders, each (image, depth, alpha) of
    the same pixels: the RGB image, the keypoint-score channel over
    ``kp_scale``, depth and alpha."""
    return {"image": (a[0][..., :3] - b[0][..., :3]).abs().amax(-1),
            "kp_score": (a[0][..., 3:] - b[0][..., 3:]).abs().amax(-1)
            / kp_scale,
            "depth": (a[1] - b[1]).abs(), "alpha": (a[2] - b[2]).abs()}


def within_limits(d: dict) -> torch.Tensor:
    """Per pixel: every difference of blend_diff_maps within
    BLEND_PAIR_LIMITS."""
    return torch.stack([d[k] <= lim for k, lim in
                        BLEND_PAIR_LIMITS.items()]).all(0)


def flip_witness(args, alive, cam, pix, sides: dict, kp_scale: float):
    """At the pixels ``pix`` ([P, 2] (x, y)) where the tiled blend and the
    pair kernels (``sides``: name -> (image, depth, alpha) at those pixels)
    differ past the limits: the per-pixel oracle (rasterize_reference:
    every Gaussian of the view in depth order, no tile lists) with the
    exact cuts, and with alpha_min or transmittance_eps nudged by each of
    CUT_NUDGES up and down; which of these reproduce each side within the
    limits. A pixel that both sides reproduce under some nudge holds a
    Gaussian at that cut, blended by one side's rounding only."""
    from splatloc_tpu_torch.raster.reference import rasterize_reference
    base = RasterConfig()
    variants = {"exact": base}
    for f in CUT_NUDGES:
        for sgn, tag in ((1, "+"), (-1, "-")):
            variants[f"alpha_min{tag}{f:g}"] = base.replace(
                alpha_min=base.alpha_min * (1 + sgn * f))
            variants[f"eps{tag}{f:g}"] = base.replace(
                transmittance_eps=base.transmittance_eps * (1 + sgn * f))
    per = [{"x": x, "y": y, **{f"{k}_alpha": float(v[2][i])
                               for k, v in sides.items()},
            **{f"{k}_matches": [] for k in sides}}
           for i, (x, y) in enumerate(pix.tolist())]
    with torch.no_grad():
        for name, cfg in variants.items():
            ref = rasterize_reference(*args, cam, cfg, alive=alive,
                                      pixels=pix)[:3]
            if name == "exact":
                for i, r in enumerate(per):
                    r["oracle_alpha"] = float(ref[2][i])
                    r["oracle_depth"] = float(ref[1][i])
            for k, v in sides.items():
                ok = within_limits(blend_diff_maps(v, ref, kp_scale))
                for i, r in enumerate(per):
                    if bool(ok[i]):
                        r[f"{k}_matches"].append(name)
    return per


def blend_vs_pair(scene, cam, pair_cfg: RasterConfig, seed: int) -> dict:
    """rasterize with use_pallas=False (the tiled blend) against
    use_pallas=True (the pair kernels, ``pair_cfg``), on the card, held to
    BLEND_PAIR_LIMITS:

    - on tests/test_pallas.py's scene (300 random Gaussians at 64x48 with
      a background), every pixel, as the JAX package holds its two paths;
    - on one 640x480 view of the learned map, all but BLEND_FLIP_SHARE of
      the pixels. The paths round power and transmittance differently, so
      a Gaussian right at the alpha_min or the transmittance cut can be
      blended by one path only. At each pixel past the limits
      flip_witness must reproduce both paths with the oracle under a
      nudged cut, and the paths may differ by at most one Gaussian's
      largest weight at a cut, w = max(alpha_min, alpha_max * eps /
      (1 - alpha_max)): alpha by w, depth by w times the view's largest
      depth, RGB by w times its largest colour, the keypoint score by w
      relative.

    The blend's per-tile cap is raised until no tile drops a Gaussian."""
    from splatloc_tpu_torch.raster import rasterize
    eps, amax = PAIR_CFG.transmittance_eps, PAIR_CFG.alpha_max
    w_cut = max(PAIR_CFG.alpha_min, amax * eps / (1.0 - amax))

    def parts(o):
        return o.image, o.depth, o.alpha

    # tests/test_pallas.py's scene and limits
    rng = np.random.default_rng(seed)
    n, W, H = 300, 64, 48
    sc = [torch.from_numpy(x).to(cam.device) for x in (
        np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                  rng.uniform(1, 5, n)], -1).astype(np.float32),
        np.exp(rng.uniform(-4.5, -2.5, (n, 3))).astype(np.float32),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0.2, 0.95, n).astype(np.float32),
        rng.uniform(0, 1, (n, 4)).astype(np.float32))]
    small = Camera.create(np.eye(4, dtype=np.float32), 50.0, 50.0, W / 2,
                          H / 2, W, H, device=cam.device)
    bg = torch.tensor([0.1, 0.2, 0.3, 0.0], device=cam.device)
    cfg = RasterConfig(tile_size=16, max_per_tile=512, tile_chunk=4)
    with torch.no_grad():
        outs = [parts(rasterize(*sc, small, cfg.replace(use_pallas=p),
                                bg=bg)) for p in (False, True)]
    res = {"jax_test_scene": {k: float(v.max()) for k, v in blend_diff_maps(
        *outs, max(1.0, float(outs[1][0][..., 3:].abs().max()))).items()}}

    colors = torch.cat([sh.sh_to_color(scene.sh_degree, scene.features(),
                                       scene.xyz, cam.camera_center),
                        scene.kp_score], dim=-1)
    args = (scene.xyz, scene.scaling_activated(), scene.rotation,
            scene.opacity_activated(), colors)

    def run(cfg):
        with torch.no_grad():
            return rasterize(*args, cam, cfg, alive=scene.alive)
    cap = 1024
    while True:
        blend = run(RasterConfig(use_pallas=False, max_per_tile=cap))
        if int(blend.n_dropped) == 0 or cap >= 16384:
            break
        cap *= 4
    pair = run(pair_cfg)
    kp_max = float(pair.image[..., 3:].abs().max())
    kp_scale = max(1.0, kp_max)
    d = blend_diff_maps(parts(blend), parts(pair), kp_scale)
    beyond = ~within_limits(d)
    res.update(map_view={k: float(v.max()) for k, v in d.items()},
               map_view_pixels_beyond=int(beyond.sum()),
               pixels=beyond.numel(), max_per_tile=cap,
               blend_n_dropped=int(blend.n_dropped),
               pair_n_dropped=int(pair.n_dropped))
    # one Gaussian's largest weight at a cut, times the view's largest
    # depth and colour (never below the limits the other pixels keep)
    proj = project.project_gaussians(args[0], args[1], args[2], cam,
                                     pair_cfg, alive=scene.alive)
    vis = proj.visible
    flip = {k: max(BLEND_PAIR_LIMITS[k], v) for k, v in (
        ("image", w_cut * float(colors[vis, :3].abs().max())),
        ("kp_score", w_cut * kp_max / kp_scale),
        ("depth", w_cut * float(proj.depth[vis].max())),
        ("alpha", w_cut))}
    ys, xs = torch.nonzero(beyond, as_tuple=True)
    pix = torch.stack([xs, ys], -1)[:int(BLEND_FLIP_SHARE * beyond.numel())
                                    + 1]
    res["flipped"] = flip_witness(
        args, scene.alive, cam, pix,
        {k: tuple(x[pix[:, 1], pix[:, 0]] for x in parts(o))
         for k, o in (("blend", blend), ("pair", pair))}, kp_scale)
    log("map: the tiled blend vs the pair kernels " + json.dumps(res)
        + f" (limits {json.dumps(BLEND_PAIR_LIMITS)}; pixels beyond them "
        f"at most {BLEND_FLIP_SHARE:g} of the map view's, each reproduced "
        f"by the oracle under a nudged cut and within "
        f"{json.dumps(flip)} there)")
    bad = [k for k, lim in BLEND_PAIR_LIMITS.items()
           if not res["jax_test_scene"][k] <= lim]
    bad += [k for k, lim in flip.items() if not res["map_view"][k] <= lim]
    if (bad or res["map_view_pixels_beyond"] > BLEND_FLIP_SHARE * res["pixels"]
            or not all(r["blend_matches"] and r["pair_matches"]
                       for r in res["flipped"])
            or res["blend_n_dropped"] or res["pair_n_dropped"]):
        raise AssertionError(f"blend and pair path differ: {bad} {res}")
    return res


def kernels_vs_plain(scene, cam, seed: int):
    """The three kernels against their plain versions on one view of
    ``scene`` (the pair array sized for it) -> (the worst absolute error of
    each, the raster config, the view's pairs)."""
    pair_cfg = size_pair_array(scene, [cam], PAIR_CFG)
    with torch.no_grad():
        walk_args, C, pr0 = walk_inputs(scene, cam, pair_cfg)
        got = hopper_raster.fwd_pairwalk(*walk_args, C, pair_cfg)
        ref = hopper_raster.fwd_pairwalk_plain(*walk_args, C, pair_cfg)
        synced(cam.w2c.device)
        mf = compare_walk(got, ref, C)
        _, _, _, errs = check_backward(walk_args, got, pr0, C, pair_cfg, seed,
                                       cam.width, cam.height)
    return ({"fwd_pairwalk": mf["max_abs_err"], **errs}, pair_cfg,
            int(walk_args[2].sum()))


def map_phase(tmp: str, seed: int, device, card: str,
              capacity: int = TRAIN_CAPACITY,
              refine_iters: int = MAP_REFINE_ITERS,
              calib: dict | None = None,
              trace_kf: int = MAP_TRACE_KF) -> dict:
    """Phase 12: cli/train_gaussians.main on phase 11's dataset (room_0's
    configuration, the loader's kept Sequence_1 frames as keyframes), with
    every kernel's launch count set to 0 just before and read just after;
    then EvalSession on the learned map (eval_rendering, eval_pose with
    refinement), the three kernels against their plain versions on query
    0's view of the learned map, and that view through the tiled blend and
    the pair kernels."""
    import yaml
    from splatloc_tpu_torch.cli import train_gaussians
    from splatloc_tpu_torch.cli.config import save_dir_for
    from splatloc_tpu_torch.cli.test import EvalSession
    from splatloc_tpu_torch.data import load_dataset

    t_phase = time.perf_counter()
    config = localize_config(tmp, calib)
    config.pop("inherit_from", None)
    cfg_path = Path(tmp) / "map.yaml"
    cfg_path.write_text(yaml.dump(config))
    trace_dir = Path(tmp) / "trace"
    save_dir = Path(save_dir_for(config))
    (save_dir / "metrics.jsonl").unlink(missing_ok=True)
    argv = ["--config", str(cfg_path), "--refinement_iters",
            str(refine_iters), "--trace_dir", str(trace_dir), "--trace_kf",
            str(trace_kf), "--capacity", str(capacity), "--device",
            str(device)]
    log("map: python -m splatloc_tpu_torch.cli.train_gaussians "
        + " ".join(argv))
    synced(device)
    reset_launches()
    t0 = time.perf_counter()
    ply_path = train_gaussians.main(argv)
    synced(device)
    wall_s = time.perf_counter() - t0
    launches = read_launches()

    recs = [json.loads(x) for x in (save_dir / "metrics.jsonl").read_text(
        ).splitlines() if x.strip()]
    kf_recs = [r for r in recs if "kf" in r]
    dataset = load_dataset(config, train=True)
    tr = config["Training"]
    iters, window = tr["mapping_itr_num"], tr["window_size"]
    want = len(dataset) * iters * window + refine_iters
    t0 = time.perf_counter()
    for i in range(len(dataset)):
        dataset.get_frame(i)
    get_frame_s = time.perf_counter() - t0

    def densify_in(r):
        return any(i % tr["gaussian_update_every"]
                   == tr["gaussian_update_offset"]
                   for i in range(r["step"] - iters + 1, r["step"] + 1))
    # the steady steps: past keyframe 0, no densify, not traced
    steady = [1.0 / r["it_per_s"] for r in kf_recs[1:]
              if not densify_in(r) and r["kf"] != trace_kf]
    res = {"keyframes": len(kf_recs), "records": len(recs),
           "wall_s": wall_s,
           "step_s_steady_mean": float(np.mean(steady)) if steady else None,
           "step_s_kf0": 1.0 / kf_recs[0]["it_per_s"],
           "loss_per_kf": [r["loss"] for r in kf_recs],
           "n_alive": recs[-1]["n_alive"],
           "n_dropped_total": recs[-1]["n_dropped_total"],
           "get_frame_s_all_kf": get_frame_s,
           "launches": launches, "launches_expected": want}
    log(f"map on {card}: " + json.dumps(res))

    # gates on what the CLI wrote
    if len(kf_recs) != len(dataset) or recs[-1].get("phase") != "refined" \
            or len(recs) != len(dataset) + 1:
        raise AssertionError(f"metrics.jsonl: {len(kf_recs)} keyframe "
                             f"records of {len(dataset)}, then "
                             f"{recs[-1]}")
    losses = res["loss_per_kf"]
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"keyframe losses {losses}: not finite, or "
                             f"the last not below the first")
    if ply_path != str(save_dir / "point_cloud" / "final"
                       / "point_cloud.ply") or not Path(ply_path).exists():
        raise AssertionError(f"no map at {ply_path}")
    again = Path(tmp) / "again.ply"
    ply.save_scene(ply.load_scene(ply_path, device=device), str(again))
    if again.read_bytes() != Path(ply_path).read_bytes():
        raise AssertionError("load_scene + save_scene changed the map's "
                             "bytes")

    session = EvalSession(config, str(save_dir), refine_with_render_loss=True,
                          device=device)
    rendering = session.eval_rendering()
    m_t, m_r = session.eval_pose()
    res["eval_rendering"] = rendering
    res["eval_pose_median_m_deg"] = [float(np.median(m_t)),
                                     float(np.median(m_r))]
    res["eval_pose_queries"] = len(m_t)
    log(f"map: the learned map ({int(session.scene.num_alive)} Gaussians): "
        f"eval_rendering {json.dumps(rendering)}, eval_pose median "
        f"{res['eval_pose_median_m_deg'][0] * 100:.3f} cm "
        f"{res['eval_pose_median_m_deg'][1]:.3f} deg over {len(m_t)} "
        f"queries")

    q0 = session.test_dataset.get_frame(0)
    ds = session.test_dataset
    cam = Camera.create(q0["w2c"], ds.fx, ds.fy, ds.cx, ds.cy, ds.width,
                        ds.height, device=device)
    # the kernels against their plain versions on the learned map
    res["kernel_errs"], pair_cfg, n_pairs = kernels_vs_plain(
        session.scene, cam, seed)
    log("map: kernels vs plain on query 0's view of the learned map "
        + json.dumps({**res["kernel_errs"], "pairs": n_pairs}))
    res["blend_vs_pair"] = blend_vs_pair(session.scene, cam, pair_cfg, seed)

    # the card's gates: every kernel ran on the mapping path, and the trace
    # of a steady keyframe's block names the forward walk. Its idle share
    # is taken against the untraced steady step's wall (the profiler slows
    # the traced block's host) and, beside it, within the trace's own span
    # of device activity
    busy_ms, span_ms, named = trace_device_ms(trace_dir)
    traced = [r for r in kf_recs if r["kf"] == trace_kf][0]
    steady_ms = (res["step_s_steady_mean"] or float("nan")) * 1e3
    res["trace"] = {"kf": trace_kf, "device_busy_ms": busy_ms,
                    "device_busy_ms_per_step": busy_ms / iters,
                    "traced_block_wall_ms": iters / traced["it_per_s"] * 1e3,
                    "untraced_steady_step_ms": steady_ms,
                    "idle_share": 1.0 - busy_ms / (iters * steady_ms),
                    "device_span_ms": span_ms,
                    "idle_share_in_span": 1.0 - busy_ms / span_ms,
                    "names_fwd_pairwalk": named}
    log(f"map: device trace of keyframe {trace_kf}'s map() block "
        + json.dumps(res["trace"]))
    if launches != raster_only(want):
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not named:
        raise AssertionError("the trace names no fwd_pairwalk launch")
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 13: the offline protocol, from frames to a replay
# --------------------------------------------------------------------------

PROTO_VOXEL = 0.02       # preprocess gen-fusion --voxel_size
# train_decoder's epochs, cut from the CLI's 41: at a host-bound 4.7-10.2
# ms a step (597 steps an epoch) 41 epochs took 136-246 s and phase 13
# 315-495 s; 10 epochs took 60-68 s. Cut to 3 to make room for phases 15
# and 16: the gate below needs the loss to fall, not to flatten
PROTO_EPOCHS = 3
# the decoder fit (a measurement beside the path; 10 epochs took 63 s)
FIT_EPOCHS = 3
NETVLAD_SHAPE = dict(n_clusters=64, whiten_dim=4096)
# the card against the port's CPU path on one input of each stage:
# NetVLAD's 13 convolutions and whitening sum in another order; the tsdf
# of one frame moves by float32 ulps where the products round apart (and a
# voxel on a pixel boundary may flip: at most TSDF_FLIP_SHARE of them,
# each within FLIP_PX of the boundary in float64); fused features average
# the same rows; one decoder step's gradients pass bf16-rounded cotangents
# (an isolated one-bf16-ulp flip where float32 sums straddle a rounding
# boundary)
PROTO_CPU_LIMITS = {"netvlad": 1e-5, "tsdf": 1e-5, "fused": 1e-5,
                    "grad_rel_l2": 1e-3}
TSDF_FLIP_SHARE = 1e-4
FUSE_FLIP_SHARE = 1e-3
FLIP_PX = 1e-3


def hwio_npz(path: Path, params: dict) -> None:
    """Port params (OIHW convs) saved in the JAX package's npz layout."""
    np.savez(path, **{k: (v.permute(2, 3, 1, 0) if v.ndim == 4 else v)
                      .cpu().numpy() for k, v in params.items()})


def write_random_weights(tmp: str, seed: int, device) -> tuple[str, str]:
    """Random SuperPoint (256-d) and NetVLAD (64 clusters, 4096-d
    whitening, made on the card) weights from ``seed``, as npz files in the
    JAX layout. The NetVLAD centers are scaled to unit norm, as k-means
    centroids of L2-normalized descriptors are: at the init's N(0, 1) scale
    the center term swamps the residuals and every image gets the same
    descriptor to 1e-6."""
    from splatloc_tpu_torch.match import netvlad, superpoint
    sp = superpoint.init_params(torch.Generator(device).manual_seed(seed),
                                device=device)
    nv = netvlad.init_params(torch.Generator(device).manual_seed(seed + 1),
                             **NETVLAD_SHAPE, device=device)
    c = nv["vlad_centers"]
    nv["vlad_centers"] = c / c.norm(dim=1, keepdim=True)
    paths = (Path(tmp) / "superpoint.npz", Path(tmp) / "netvlad.npz")
    hwio_npz(paths[0], sp)
    hwio_npz(paths[1], nv)
    return str(paths[0]), str(paths[1])


def protocol_config(tmp: str, calib: dict | None) -> tuple[dict, Path]:
    """Phase 11's configuration with a fresh generated folder and results
    directory, written as the YAML the CLIs read."""
    import yaml
    config = localize_config(tmp, calib)
    config.pop("inherit_from", None)
    config["Dataset"]["generated_folder"] = str(Path(tmp) / "proto_gen")
    config["Results"]["save_dir"] = str(Path(tmp) / "proto_results")
    path = Path(tmp) / "protocol.yaml"
    path.write_text(yaml.dump(config))
    return config, path


def pose_report(path: Path) -> list[float]:
    """The four medians (retrieval t, r; match t, r) of a pose report."""
    import re
    flat = [float(x) for pair in re.findall(
        r"Trans\.\(cm\): ([-\d.e+naif]+)\. Rotation\(deg\): ([-\d.e+naif]+)\.",
        path.read_text()) for x in pair]
    if len(flat) != 4:
        raise AssertionError(f"{path} does not parse: {path.read_text()}")
    return flat


def run_stage(name: str, fn, stages: dict, device):
    """Run one CLI stage, its wall time into ``stages``; returns its
    result and what it printed (also echoed to the log)."""
    import contextlib
    import io
    buf = io.StringIO()
    synced(device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    synced(device)
    stages[name] = time.perf_counter() - t0
    printed = buf.getvalue()
    for line in printed.splitlines()[-12:]:
        log(f"  {name}: {line}")
    return out, printed


def flipped_on_boundary(vol, frame, K, flipped) -> bool:
    """Each flipped voxel projects, in float64, within FLIP_PX of a pixel
    boundary (x.5) in x or y, where a float32 rounding may take either
    side."""
    idx = np.argwhere(flipped).astype(np.float64)
    world = idx * vol.voxel_size + vol.origin.cpu().numpy().astype(
        np.float64)
    w2c = np.linalg.inv(frame["c2w"].astype(np.float64))
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    px = cam[:, 0] * K[0, 0] / cam[:, 2] + K[0, 2]
    py = cam[:, 1] * K[1, 1] / cam[:, 2] + K[1, 2]
    frac = np.minimum(np.abs(px - np.floor(px) - 0.5),
                      np.abs(py - np.floor(py) - 0.5))
    return bool((frac < FLIP_PX).all())


def rel_l2_np(a, b) -> float:
    a = np.asarray(a, np.float64)
    return float(np.linalg.norm(a - np.asarray(b, np.float64))
                 / max(np.linalg.norm(a), 1e-30))


def protocol_cpu_check(config, nv_path: str, sp_path: str, xyz, seed: int,
                       device) -> dict:
    """Each stage on one input, the card against the port's CPU path:
    NetVLAD's descriptor of one image and the whole retrieval table
    (identical), the TSDF volume after one frame, the fused features of
    4,096 points of the cloud over the kept frames (the same descriptor
    maps on both), and one decoder step's gradients."""
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.fields import FeatureFieldConfig, fusion, \
        init_decoder
    from splatloc_tpu_torch.match import netvlad, superpoint
    from splatloc_tpu_torch.train import decoder_train

    res = {}
    train = load_dataset(config, train=True)
    test = load_dataset(config, train=False)
    train.load_score_flag = test.load_score_flag = False
    nv = {d: netvlad.load_params(nv_path, d) for d in (device, "cpu")}

    def table(d):
        def descs(ds):
            return torch.stack([netvlad.global_descriptor(
                nv[d], torch.as_tensor(ds.load_image(i), device=d))
                for i in range(len(ds))])
        db, q = descs(train), descs(test)
        idx, _ = netvlad.top_k_retrieval(q, db, k=min(10, len(train)))
        return db, idx.cpu().numpy()
    t0 = time.perf_counter()
    db_card, idx_card = table(device)
    db_cpu, idx_cpu = table("cpu")
    res["netvlad"] = float((db_card.cpu() - db_cpu).abs().max())
    res["retrieval_same"] = bool((idx_card == idx_cpu).all())
    res["netvlad_cpu_s"] = time.perf_counter() - t0
    written = (Path(train.generated_folder) / "netvlad_retrieval.txt"
               ).read_text().splitlines()
    res["retrieval_file_same"] = written == [
        test.index_to_name(i) + " " + " ".join(
            train.index_to_name(j) for j in idx_cpu[i])
        for i in range(len(test))]
    del nv, db_card

    frame = train.get_frame(0)
    bound = np.asarray(config["scene"]["bound"], np.float32)
    vols = [fusion.integrate_frame(
        fusion.TSDFVolume.create(bound, PROTO_VOXEL, device=d),
        frame["depth"], frame["rgb"], train.K, frame["c2w"])
        for d in (device, "cpu")]
    g, c = vols
    flipped = ((g.weight.cpu() != c.weight)
               | (g.color.cpu() != c.color).any(-1)).numpy()
    res["voxels"] = int(flipped.size)
    res["tsdf_flips"] = int(flipped.sum())
    res["tsdf_flips_on_boundary"] = (not flipped.any()) or \
        flipped_on_boundary(c, frame, train.K, flipped)
    diff = (g.tsdf.cpu() - c.tsdf).abs().numpy()
    res["tsdf"] = float(diff[~flipped].max())
    del vols, g, c

    sp = superpoint.load_params(sp_path, device)
    pick = np.random.default_rng(seed + 14).choice(len(xyz), 4096,
                                                    replace=False)
    maps = []
    for i in range(len(train)):
        f = train.get_frame(i)
        gray = torch.as_tensor((0.299 * f["rgb"][..., 0]
                                + 0.587 * f["rgb"][..., 1]
                                + 0.114 * f["rgb"][..., 2]
                                ).astype(np.float32), device=device)
        _, coarse = superpoint.dense_outputs(sp, gray)
        dense = coarse.repeat_interleave(8, 0).repeat_interleave(8, 1)
        maps.append((dense, f["depth"], f["c2w"]))
    fg, wg = fusion.fuse_point_features(xyz[pick], maps, train.K, 256,
                                        device=device)
    fc, wc = fusion.fuse_point_features(
        xyz[pick], [(m.cpu(), d, c2w) for m, d, c2w in maps], train.K, 256,
        device="cpu")
    same = wg == wc
    res["fused_points"] = int(len(pick))
    res["fused_weight_flips"] = int((~same).sum())
    res["fused"] = float(np.abs(fg[same] - fc[same]).max())
    del maps

    cfg = FeatureFieldConfig.from_config(config)
    params = init_decoder(cfg, torch.Generator(device).manual_seed(seed),
                          device=device)
    x = torch.as_tensor(xyz[pick[:256]], device=device)
    f = torch.as_tensor(fc[:256], device=device)
    grads = {}
    for d in (device, "cpu"):
        p = {"table": params["table"].to(d).clone().requires_grad_(),
             "layers": [w.to(d).clone().requires_grad_()
                        for w in params["layers"]]}
        opt = decoder_train.make_optimizer(p)
        decoder_train.train_step(p, opt, x.to(d), f.to(d), cfg)
        grads[d] = [t.grad.cpu().numpy() for t in [p["table"],
                                                    *p["layers"]]]
    res["grad_rel_l2"] = max(rel_l2_np(a, b) for a, b in
                             zip(grads["cpu"], grads[device]))
    return res


def decoder_step_report(cfg, xyz, feats, seed: int, device) -> dict:
    """One decoder training step at the configuration's width and batch
    256: its wall time (50 steps, synchronised), its host syncs, a device
    profile (ops, busy time, idle share), and hash-grid encode's forward
    and backward in the repaired one-gather form against the per-level
    form it replaced (device ops and busy ms per call)."""
    from splatloc_tpu_torch.fields import hashgrid, init_decoder
    from splatloc_tpu_torch.train import decoder_train
    params = init_decoder(cfg, torch.Generator(device).manual_seed(seed + 1),
                          device=device)
    for t in [params["table"], *params["layers"]]:
        t.requires_grad_(True)
    opt = decoder_train.make_optimizer(params)
    idx = torch.as_tensor(np.random.default_rng(seed).permutation(
        len(xyz))[:256], device=device)
    x = torch.as_tensor(xyz, device=device)[idx]
    f = torch.as_tensor(feats, device=device)[idx]

    def step():
        return decoder_train.train_step(params, opt, x, f, cfg)
    for _ in range(3):
        step()
    synced(device)
    t0 = time.perf_counter()
    for _ in range(50):
        step()
    synced(device)
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    _, syncs = count_syncs(step)
    res = {"step_wall_ms": wall_ms, "step_syncs": syncs,
           "step_profile": profile(step, wall_ms, 5, warm=True)}
    g = cfg.grid_config
    pos = torch.rand((256, 3), generator=torch.Generator(device).manual_seed(
        seed), device=device)
    table = params["table"].detach().clone().requires_grad_()
    for name, fn in (("encode", hashgrid.encode),
                     ("encode_per_level", hashgrid.encode_per_level)):
        def fwd_bwd(fn=fn):
            fn(table, pos, g).sum().backward()
        fwd_bwd()
        t0 = time.perf_counter()
        fwd_bwd()
        synced(device)
        ms = (time.perf_counter() - t0) * 1e3
        p = profile(fwd_bwd, ms, 3, warm=True)
        res[name] = {k: p[k] for k in ("wall_ms", "device_busy_ms",
                                       "device_ops_per_call")}
        table.grad = None
    return res


def decoder_runs_identical(cfg, xyz, feats, seed: int, device,
                           epochs: int = 1) -> bool:
    """Two train_decoder runs from the same seed on the fused cloud give
    the same bits."""
    from splatloc_tpu_torch.train import decoder_train
    outs = [decoder_train.train_decoder(cfg, xyz, feats, num_epochs=epochs,
                                        seed=seed, log_every=0,
                                        device=device)[0]
            for _ in range(2)]
    return all(torch.equal(a, b) for a, b in
               zip([outs[0]["table"], *outs[0]["layers"]],
                   [outs[1]["table"], *outs[1]["layers"]]))


def decoder_fit(tmp: str, xyz, seed: int, device, calib: dict | None,
                epochs: int = FIT_EPOCHS) -> dict:
    """The descriptor field learned at full width: the fused points
    labelled by phase 11's seeded decoder train a decoder from another
    seed (the per-epoch losses kept on the card, read once), which then
    localizes phase 11's queries (their descriptors are phase 11's
    decoder's at the true key Gaussians, plus noise) from phase 12's
    learned map."""
    from splatloc_tpu_torch.cli.config import save_dir_for
    from splatloc_tpu_torch.cli.test import EvalSession
    from splatloc_tpu_torch.fields import FeatureFieldConfig, decode, \
        init_decoder
    from splatloc_tpu_torch.train import decoder_train

    config = localize_config(tmp, calib)
    cfg = FeatureFieldConfig.from_config(config)
    teacher = init_decoder(cfg, torch.Generator(device).manual_seed(seed),
                           device=device)
    xyz_d = torch.as_tensor(xyz, device=device)
    with torch.no_grad():
        labels = torch.cat([decode(teacher, xyz_d[i:i + 65536], cfg)
                            for i in range(0, len(xyz_d), 65536)])
    del teacher
    params = init_decoder(cfg, torch.Generator(device).manual_seed(seed + 2),
                          device=device)
    for t in [params["table"], *params["layers"]]:
        t.requires_grad_(True)
    opt = decoder_train.make_optimizer(params)
    epoch_fn = decoder_train.make_train_epoch(cfg, opt, params)
    rng = np.random.default_rng(seed)
    n_batches = len(xyz) // 256
    t0 = time.perf_counter()
    losses = [epoch_fn(xyz_d, labels, torch.as_tensor(
        rng.permutation(len(xyz))[:n_batches * 256].reshape(n_batches, 256),
        device=device)) for _ in range(epochs)]
    curve = torch.stack(losses).cpu().tolist()
    train_s = time.perf_counter() - t0

    src = Path(save_dir_for(config))
    config["Results"]["save_dir"] = str(Path(tmp) / "fit_results")
    save_dir = Path(save_dir_for(config))
    (save_dir / "point_cloud" / "final").mkdir(parents=True, exist_ok=True)
    shutil.copy(src / "point_cloud" / "final" / "point_cloud.ply",
                save_dir / "point_cloud" / "final" / "point_cloud.ply")
    decoder_train.save_params(params, str(save_dir / "train_feat"
                                          / "ckpt.npz"))
    session = EvalSession(config, str(save_dir), device=device)
    t0 = time.perf_counter()
    m_t, m_r = session.eval_pose()
    report = pose_report(save_dir / "eval_pose.txt")
    solved = (save_dir / "eval_pose.txt").read_text()
    return {"epochs": epochs, "points": int(len(xyz)),
            "loss_curve": curve, "train_s": train_s,
            "eval_pose_s": time.perf_counter() - t0,
            "queries": len(m_t),
            "solved_line": [x for x in solved.splitlines()
                            if x.startswith("Solved")],
            "median_m_deg": [float(np.median(m_t)), float(np.median(m_r))],
            "report_cm_deg": report, "limits": LOC_LIMITS}


def protocol_phase(tmp: str, seed: int, device, card: str,
                   calib: dict | None = None, epochs: int = PROTO_EPOCHS,
                   capacity: int = TRAIN_CAPACITY,
                   refine_iters: int = MAP_REFINE_ITERS,
                   fit_epochs: int = FIT_EPOCHS) -> dict:
    """Phase 13: the protocol on phase 11's frames through every CLI's
    main (preprocess extract-features, gen-retrieval, gen-fusion;
    train_gaussians; train_decoder; test --eval_pose --eval_rendering
    --eval_selection --save_pose --save_match; replay), into a fresh
    generated folder, with every kernel's launch count set to 0 just before
    and read just after; then each stage on one input against the CPU
    path, the kernels against their plain versions on the learned map,
    the decoder step's profile, two decoder runs compared bit for bit, and
    the decoder fit."""
    from splatloc_tpu_torch.cli import preprocess, replay, train_decoder
    from splatloc_tpu_torch.cli import test as cli_test
    from splatloc_tpu_torch.cli import train_gaussians
    from splatloc_tpu_torch.cli.config import save_dir_for
    from splatloc_tpu_torch.data import load_dataset
    from splatloc_tpu_torch.fields import FeatureFieldConfig, mesh
    from splatloc_tpu_torch.scene.ply import read_ply_vertices

    t_phase = time.perf_counter()
    config, cfg_path = protocol_config(tmp, calib)
    sp_path, nv_path = write_random_weights(tmp, seed, device)
    gen = Path(config["Dataset"]["generated_folder"]) / Path(
        config["Dataset"]["dataset_path"]).name
    save_dir = Path(save_dir_for(config))
    dev = ["--device", str(device)]
    cfg = ["--config", str(cfg_path)]
    stages = {}
    log(f"protocol: set-up (random weights, NetVLAD "
        f"{json.dumps(NETVLAD_SHAPE)}) {time.perf_counter() - t_phase:.1f} s")

    synced(device)
    reset_launches()
    run_stage("extract_features", lambda: preprocess.main(
        ["extract-features", *cfg, "--superpoint", sp_path, *dev]), stages,
        device)
    run_stage("gen_retrieval", lambda: preprocess.main(
        ["gen-retrieval", *cfg, "--netvlad", nv_path, *dev]), stages, device)
    _, fusion_out = run_stage("gen_fusion", lambda: preprocess.main(
        ["gen-fusion", *cfg, "--superpoint", sp_path, "--voxel_size",
         str(PROTO_VOXEL), *dev]), stages, device)
    run_stage("train_gaussians", lambda: train_gaussians.main(
        [*cfg, "--refinement_iters", str(refine_iters), "--capacity",
         str(capacity), *dev]), stages, device)
    ckpt, dec_out = run_stage("train_decoder", lambda: train_decoder.main(
        [*cfg, "--num_epochs", str(epochs), *dev]), stages, device)
    run_stage("test", lambda: cli_test.main(
        [*cfg, "--eval_pose", "--eval_rendering", "--eval_selection",
         "--save_pose", "--save_match", *dev]), stages, device)
    # every query replayed: random weights localize some far off
    run_stage("replay", lambda: replay.main(
        ["--save_dir", str(save_dir), "--mesh", str(gen / "mesh.ply"),
         "--out", str(save_dir / "replay3d"), "--max_dist", "1000"]),
        stages, device)
    launches = read_launches()

    # what the stages wrote
    v = read_ply_vertices(str(gen / "sp_inloc_pc.ply"))
    xyz = np.stack([v["x"], v["y"], v["z"]], -1).astype(np.float32)
    feats = np.load(gen / "sp_inloc_feat.npy").astype(np.float32)
    verts, faces, _, _ = mesh.load_mesh_ply(str(gen / "mesh.ply"))
    curve = [float(x.split("cos loss ")[1]) for x in dec_out.splitlines()
             if x.startswith("decoder epoch")]
    train_ds = load_dataset(config, train=True)
    test_ds = load_dataset(config, train=False)
    rendering = (save_dir / "eval_rendering.txt").read_text()
    psnr = float(rendering.split("mean_psnr: ")[1].split()[0])
    frames = sorted((save_dir / "replay3d").glob("frame_*.png"))
    res = {"stages_s": stages, "phase_stages_s": sum(stages.values()),
           "fused_points": int(len(xyz)),
           "surface_line": [x for x in fusion_out.splitlines()
                            if "surface points" in x],
           "mesh": [int(len(verts)), int(len(faces))],
           "decoder_epochs": epochs,
           "decoder_steps_per_epoch": max(len(xyz) // 256, 1),
           "decoder_loss_logged": curve,
           "eval_pose_cm_deg": pose_report(save_dir / "eval_pose.txt"),
           "eval_selection_cm_deg": pose_report(
               save_dir / "eval_selection_5000.txt"),
           "psnr": psnr, "replay_frames": len(frames),
           "launches": launches}
    log(f"protocol on {card}: " + json.dumps(res))

    # gates on the artifacts of tests/test_cli_protocol.py and the rest
    need = [gen / "netvlad_retrieval.txt", gen / "sp_inloc_pc.ply",
            gen / "sp_inloc_feat.npy", gen / "mesh.ply",
            save_dir / "point_cloud" / "final" / "point_cloud.ply",
            save_dir / "train_feat" / "ckpt.npz",
            save_dir / "save_pose" / "match_t.npy"]
    missing = [str(p) for p in need if not p.exists()]
    if missing or ckpt != str(save_dir / "train_feat" / "ckpt.npz"):
        raise AssertionError(f"protocol artifacts missing: {missing}")
    table = (gen / "netvlad_retrieval.txt").read_text().splitlines()
    if len(table) != len(test_ds) or any(
            len(r.split()) != 1 + min(10, len(train_ds)) for r in table):
        raise AssertionError(f"retrieval table {table}")
    if len(list((gen / "score_map").glob("*_score.npy"))) != len(train_ds):
        raise AssertionError("a score map is missing")
    if feats.shape != (len(xyz), 256) or len(xyz) < 1000 or len(faces) < 1000:
        raise AssertionError(f"fused cloud {feats.shape} for {len(xyz)} "
                             f"points, mesh {len(faces)} faces")
    medians = res["eval_pose_cm_deg"] + res["eval_selection_cm_deg"]
    if not (np.isfinite(medians).all() and psnr > 10.0
            and "mean_ssim:" in rendering and "mean_lpips:" in rendering):
        raise AssertionError(f"medians {medians}, PSNR {psnr}: {rendering}")
    if len(frames) != len(test_ds) or len(list(
            (save_dir / "save_match").glob("*.npy"))) != len(test_ds):
        raise AssertionError(f"{len(frames)} replay frames for "
                             f"{len(test_ds)} queries")
    if len(curve) < 2 or not curve[-1] < curve[0]:
        raise AssertionError(f"decoder loss did not fall: {curve}")
    if any(launches[k] < 1 for k in RASTER_KERNELS):
        raise AssertionError(f"a kernel did not launch in the protocol: "
                             f"{launches}")

    t0 = time.perf_counter()
    chk = protocol_cpu_check(config, nv_path, sp_path, xyz, seed, device)
    chk["check_s"] = time.perf_counter() - t0
    log("protocol: each stage on the card vs the CPU path "
        + json.dumps(chk) + f" (limits {json.dumps(PROTO_CPU_LIMITS)}, "
        f"flip shares {TSDF_FLIP_SHARE}, {FUSE_FLIP_SHARE})")
    bad = [k for k, lim in PROTO_CPU_LIMITS.items() if not chk[k] <= lim]
    if (bad or not chk["retrieval_same"] or not chk["retrieval_file_same"]
            or chk["tsdf_flips"] > TSDF_FLIP_SHARE * chk["voxels"]
            or not chk["tsdf_flips_on_boundary"]
            or chk["fused_weight_flips"]
            > FUSE_FLIP_SHARE * chk["fused_points"]):
        raise AssertionError(f"card and CPU path differ: {bad} {chk}")
    res["cpu_check"] = chk

    # the kernels against their plain versions on query 0's view of the
    # protocol's learned map
    from splatloc_tpu_torch.scene import ply as ply_mod
    scene = ply_mod.load_scene(str(save_dir / "point_cloud" / "final"
                                   / "point_cloud.ply"), device=device)
    q0 = test_ds.get_frame(0)
    cam = Camera.create(q0["w2c"], test_ds.fx, test_ds.fy, test_ds.cx,
                        test_ds.cy, test_ds.width, test_ds.height,
                        device=device)
    res["kernel_errs"], _, n_pairs = kernels_vs_plain(scene, cam, seed)
    log("protocol: kernels vs plain on query 0's view of the learned map "
        + json.dumps({**res["kernel_errs"], "pairs": n_pairs}))
    del scene

    fcfg = FeatureFieldConfig.from_config(config)
    t0 = time.perf_counter()
    res["step"] = decoder_step_report(fcfg, xyz, feats, seed, device)
    log(f"protocol: decoder step ({time.perf_counter() - t0:.1f} s) "
        + json.dumps(res["step"]))
    t0 = time.perf_counter()
    res["decoder_bit_identical"] = decoder_runs_identical(fcfg, xyz, feats,
                                                          seed, device)
    log(f"protocol: two train_decoder runs (1 epoch each, seed {seed}) "
        f"bit-identical: {res['decoder_bit_identical']} "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    res["fit"] = decoder_fit(tmp, xyz, seed, device, calib, fit_epochs)
    log(f"protocol: decoder fit ({time.perf_counter() - t0:.1f} s) "
        + json.dumps(res["fit"]))
    if not res["fit"]["loss_curve"][-1] < res["fit"]["loss_curve"][0]:
        raise AssertionError(f"the fit's loss did not fall: "
                             f"{res['fit']['loss_curve']}")
    res["phase_s"] = time.perf_counter() - t_phase
    return res


# --------------------------------------------------------------------------
# phase 14: the multi-GPU layer, every rank on the card
# --------------------------------------------------------------------------

# rank groups of the phase; ranks that share one card talk over gloo (nccl
# refuses two ranks on one device), nccl runs where each rank has a card
DIST_WORLDS = (2, 4)
# a group that has not finished in this time is killed and the phase fails
DIST_TIMEOUT_S = 300.0
# (a) the sharded backward against the single-process one: the same
# per-pair gradients, a Gaussian's per-tile sums added across ranks in
# another order
DIST_GRAD_REL_L2 = 1e-6
# (b) the sharded mapping step against the unsharded one (tests/test_dist.py
# ::test_sharded_mapping_step_runs' limits): the window's losses and
# gradients summed over ranks in another order
DIST_STEP_LIMITS = {"loss_rtol": 1e-5, "xyz_atol": 1e-5}
DIST_SERVE_GRADS = ("means", "opacities", "colors")


def serve_leaves(scene, cam) -> dict:
    """The inputs ``render`` gives ``rasterize`` for this view, as leaves
    that take gradients."""
    colors = torch.cat([sh.sh_to_color(scene.sh_degree, scene.features(),
                                       scene.xyz, cam.camera_center),
                        scene.kp_score], dim=-1)
    leaves = {"means": scene.xyz, "scales": scene.scaling_activated(),
              "quats": scene.rotation,
              "opacities": scene.opacity_activated(), "colors": colors}
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in leaves.items()}


def dist_loss(out) -> torch.Tensor:
    """tests/test_dist.py's loss on a render."""
    return torch.mean(out.image ** 2) + 0.1 * torch.mean(out.depth)


def trainer_state(trainer) -> dict:
    """A trainer's configuration, scene, Adam state, densify statistics
    and its first window of keyframes, as tensors."""
    sc = trainer.scene
    return {"cfg": trainer.cfg,
            "scene": {k: getattr(sc, k) for k in
                      GaussianScene.PARAM_FIELDS + ("alive",)},
            "sh_degree": sc.sh_degree,
            "opt": {"step": trainer.opt_state.step,
                    "m": trainer.opt_state.m, "v": trainer.opt_state.v},
            "stats": {k: getattr(trainer.stats, k) for k in
                      ("xyz_gradient_accum", "denom", "max_radii2d")},
            "frames": trainer.frames.gather(range(trainer.cfg.window_size))}


def state_objects(state: dict, device):
    """(scene, opt_state, stats, frames) of trainer_state's dict."""
    from splatloc_tpu_torch.scene import densify, optim
    to = {k: v.to(device) for k, v in state["scene"].items()}
    scene = GaussianScene(**to, sh_degree=state["sh_degree"])
    o = state["opt"]
    opt = optim.AdamState(step=o["step"].to(device),
                          m={k: v.to(device) for k, v in o["m"].items()},
                          v={k: v.to(device) for k, v in o["v"].items()})
    stats = densify.DensifyStats(**{k: v.to(device)
                                    for k, v in state["stats"].items()})
    frames = {k: v.to(device) for k, v in state["frames"].items()}
    return scene, opt, stats, frames


def dist_inputs(work: Path, scene, cam, cfg, room, seed: int, device,
                capacity: int, cfg_changes: dict | None) -> dict:
    """Writes what the ranks read: (a) the serve scene's view ``cam`` with
    the single-process render and grads, (b) a trainer on phase 9's
    configuration after one window of keyframes, with the single-process
    mapping step from its state. Returns what is logged of them."""
    from splatloc_tpu_torch.raster import rasterize
    from splatloc_tpu_torch.train.mapping import make_mapping_step
    leaves = serve_leaves(scene, cam)
    out = rasterize(*leaves.values(), cam, cfg)
    grads = torch.autograd.grad(dist_loss(out), [leaves[k] for k in
                                                 DIST_SERVE_GRADS])
    torch.save({"leaves": {k: v.detach() for k, v in leaves.items()},
                "w2c": cam.w2c, "intrinsics": (cam.fx, cam.fy, cam.cx,
                                               cam.cy, cam.width,
                                               cam.height),
                "cfg": cfg, "image": out.image.detach(),
                "depth": out.depth.detach(),
                "grads": dict(zip(DIST_SERVE_GRADS, grads))},
               work / "serve.pt")

    tcfg = replica_config(**(cfg_changes or {}))
    trainer = MappingTrainer(tcfg, capacity=capacity, seed=seed,
                             device=device)
    for f in make_keyframes(room, tcfg, tcfg.window_size, device):
        trainer.add_keyframe(*f)
    state = trainer_state(trainer)
    sc, opt, stats, frames = state_objects(state, device)
    s, _, _, loss, _, nd = make_mapping_step(state["cfg"])(
        sc, opt, stats, frames, 1)
    state["ref"] = {"loss": loss, "xyz": s.xyz, "n_dropped": nd}
    torch.save(state, work / "train.pt")
    synced(device)
    return {"serve_visible": int((out.radii > 0).sum()),
            "train_alive": int(trainer.scene.num_alive),
            "train_capacity": trainer.scene.capacity,
            "train_views": tcfg.window_size,
            "train_loss": float(loss), "train_n_dropped": nd.tolist()}


def _syncs(fn, device):
    """(fn's result, its host syncs on the card; None on the CPU)."""
    if torch.device(device).type != "cuda":
        return fn(), None
    return count_syncs(fn)


def _rank_render(mesh, work: Path, device) -> dict:
    """Phase 14 (a) on one rank: the serve view through rasterize_sharded,
    forward and backward, twice (the first run also loads the kernels and
    opens the group's connections), each held to the single-process
    render."""
    from splatloc_tpu_torch.dist.sharded_raster import rasterize_sharded
    from splatloc_tpu_torch.utils.profiling import log_collectives
    inp = torch.load(work / "serve.pt", map_location=device,
                     weights_only=False)
    fx, fy, cx, cy, w, h = inp["intrinsics"]
    cam = Camera.create(inp["w2c"].cpu().numpy(), fx, fy, cx, cy, w, h,
                        device=device)
    cfg = inp["cfg"]
    leaves = {k: v.requires_grad_(True) for k, v in inp["leaves"].items()}
    runs = []
    synced(device)
    reset_launches()
    for _ in range(2):
        t0 = time.perf_counter()
        with log_collectives() as fwd_log:
            out, fwd_syncs = _syncs(lambda: rasterize_sharded(
                *leaves.values(), cam, cfg, mesh), device)
        synced(device)
        t1 = time.perf_counter()
        with log_collectives() as bwd_log:
            grads, bwd_syncs = _syncs(lambda: torch.autograd.grad(
                dist_loss(out), [leaves[k] for k in DIST_SERVE_GRADS]),
                device)
        synced(device)
        runs.append({
            "fwd_ms": (t1 - t0) * 1e3,
            "bwd_ms": (time.perf_counter() - t1) * 1e3,
            "counters": [int(out.n_dropped), int(out.n_trunc),
                         int(out.n_vis_dropped)],
            "syncs": {"forward": fwd_syncs, "backward": bwd_syncs},
            "collectives": {"forward": fwd_log, "backward": bwd_log},
            "image_equal": bool(torch.equal(out.image, inp["image"])),
            "depth_equal": bool(torch.equal(out.depth, inp["depth"])),
            "grad_rel_l2": {k: rel_l2(g, inp["grads"][k])
                            for k, g in zip(DIST_SERVE_GRADS, grads)}})
    launches = read_launches()
    # this rank's pair array and pairs, rebuilt outside the counted runs
    with torch.no_grad():
        proj = project.project_gaussians(
            leaves["means"], leaves["scales"], leaves["quats"], cam, cfg,
            opacities=leaves["opacities"])
        gpair, pr, _ = hopper_raster._pair_inputs(
            (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c),
            leaves["opacities"], proj.depth, leaves["colors"],
            (proj.radius_x, proj.radius_y), proj.visible,
            binning.depth_sort(proj), w, h, cfg, mesh, "tile")
    res = {"pairs": int(pr["counts"].sum()),
           "pair_array": int(gpair.shape[1]),
           "tiles": int(pr["counts"].numel()), "launches": launches,
           "runs": runs}
    bad = []
    for i, r in enumerate(runs):
        bad += [f"run {i} {k}" for k in ("image_equal", "depth_equal")
                if not r[k]]
        bad += [f"run {i} {k}" for k, e in r["grad_rel_l2"].items()
                if not e <= DIST_GRAD_REL_L2]
        if r["counters"][0] != 0:
            bad.append(f"run {i} n_dropped")
    if bad:
        raise AssertionError(f"rank {mesh.rank}: the sharded render "
                             f"disagrees with the single-process one on "
                             f"{bad}: {json.dumps(res)}")
    return res


def _rank_step(mesh, work: Path, device) -> dict:
    """Phase 14 (b) on one rank: make_sharded_mapping_step on a (data=2,
    gauss=2) mesh, twice from the same state, held to the unsharded step
    and to itself bit for bit."""
    from splatloc_tpu_torch.dist import shard
    from splatloc_tpu_torch.utils.profiling import log_collectives
    state = torch.load(work / "train.pt", map_location=device,
                       weights_only=False)
    scene, opt, stats, frames = state_objects(state, device)
    step = shard.make_sharded_mapping_step(state["cfg"], mesh)
    runs, walls, logs, syncs = [], [], [], []
    launches = {k: 0 for k in read_launches()}
    for _ in range(2):
        opt_sh, stats_sh = shard.shard_state(mesh, opt, stats)
        scene_sh = shard.shard_scene(mesh, scene)
        synced(device)
        reset_launches()
        t0 = time.perf_counter()
        with log_collectives() as calls:
            out, n_sync = _syncs(lambda: step(scene_sh, opt_sh, stats_sh,
                                              frames, 1), device)
        synced(device)
        walls.append((time.perf_counter() - t0) * 1e3)
        launches = {k: n + read_launches()[k] for k, n in launches.items()}
        logs.append(calls)
        syncs.append(n_sync)
        s, o, st, loss, vis, nd = out
        full = shard.gather_scene(mesh, s)
        got = {f"scene.{k}": getattr(full, k) for k in shard.SCENE_FIELDS}
        for k in o.m:
            got[f"m.{k}"] = mesh.all_gather(o.m[k], "gauss")
            got[f"v.{k}"] = mesh.all_gather(o.v[k], "gauss")
        for k in shard.STATS_FIELDS:
            got[f"stats.{k}"] = mesh.all_gather(getattr(st, k), "gauss")
        got.update({"vis": mesh.all_gather(vis, "gauss"), "loss": loss,
                    "n_dropped": nd})
        runs.append(got)
    ref = state["ref"]
    differ = [k for k in runs[0] if not torch.equal(runs[0][k], runs[1][k])]
    loss_rel = abs(float(runs[0]["loss"]) - float(ref["loss"])) / abs(
        float(ref["loss"]))
    xyz_err = float((runs[0]["scene.xyz"] - ref["xyz"]).abs().max())
    res = {"step_ms": walls, "loss": float(runs[0]["loss"]),
           "ref_loss": float(ref["loss"]), "loss_rel": loss_rel,
           "xyz_max_abs": xyz_err,
           "n_dropped": runs[0]["n_dropped"].tolist(),
           "runs_differ_on": differ, "launches": launches,
           "syncs": syncs, "collectives": logs[0],
           "views": len(range(mesh.index("data"), frames["w2c"].shape[0],
                              mesh.shape["data"]))}
    bad = list(differ)
    if not loss_rel <= DIST_STEP_LIMITS["loss_rtol"]:
        bad.append("loss")
    if not xyz_err <= DIST_STEP_LIMITS["xyz_atol"]:
        bad.append("xyz")
    if not torch.equal(runs[0]["n_dropped"], ref["n_dropped"]):
        bad.append("n_dropped")
    if bad:
        raise AssertionError(f"rank {mesh.rank}: the sharded mapping step "
                             f"fails on {bad}: {json.dumps(res)}")
    return res


def dist_rank(rank: int, world: int, port: int, backend: str, work: str,
              device_type: str) -> None:
    """One rank of a phase 14 group (torch.multiprocessing.spawn's
    target): joins the group, runs (a) on a tile mesh of every rank and, in
    a group of 4, (b) on a (2, 2) mesh, and writes its results to
    ``work/rank<world>_<rank>.json``. Any failed check raises."""
    import torch.distributed as dist
    from splatloc_tpu_torch.dist import multihost, shard
    work = Path(work)
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        res = {"rank": rank, "world": world, "backend": backend,
               "device": str(device),
               "render": _rank_render(multihost.global_mesh(tile=world),
                                      work, device)}
        if world == 4:
            res["step"] = _rank_step(shard.make_mesh(data=2, gauss=2),
                                     work, device)
        (work / f"rank{world}_{backend}_{rank}.json").write_text(
            json.dumps(res))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_group(world: int, backend: str, work: Path, device) -> list:
    """Spawns ``world`` ranks of dist_rank and waits for them all: a rank
    that raises, or a group past DIST_TIMEOUT_S, fails the phase and no
    rank is left running. Returns the ranks' results."""
    import torch.multiprocessing as mp
    ctx = mp.spawn(dist_rank, args=(world, _free_port(), backend, str(work),
                                    torch.device(device).type),
                   nprocs=world, join=False)
    deadline = time.perf_counter() + DIST_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.perf_counter() > deadline:
                raise TimeoutError(f"{world} {backend} ranks still running "
                                   f"after {DIST_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [json.loads((work / f"rank{world}_{backend}_{r}.json")
                       .read_text()) for r in range(world)]


def _collective_summary(calls: list) -> list:
    return [f"{c['op']} {c['dtype']}{c['shape']} {c['bytes']} B"
            for c in calls]


def dist_phase(scene, cam, cfg, seed: int, device, card: str,
               capacity: int = TRAIN_CAPACITY,
               cfg_changes: dict | None = None, room=None) -> dict:
    """Phase 14: rasterize_sharded on the serve view and the sharded
    mapping step, in groups of DIST_WORLDS ranks on the card."""
    t_phase = time.perf_counter()
    if room is None:
        room = make_room_scene(N_GAUSSIANS, seed, device)
    backends = {w: ["gloo"] + (["nccl"] if torch.device(device).type
                               == "cuda" and torch.cuda.device_count() >= w
                               else []) for w in DIST_WORLDS}
    launches = {"fwd_pairwalk": 0, "bwd_pairwalk": 0, "seg_reduce": 0}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    try:
        info = dist_inputs(work, scene, cam, cfg, room, seed, device,
                           capacity, cfg_changes)
        log(f"dist: inputs {json.dumps(info)}")
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        groups = {}
        for world in DIST_WORLDS:
            for backend in backends[world]:
                t0 = time.perf_counter()
                ranks = run_group(world, backend, work, device)
                wall = time.perf_counter() - t0
                groups[f"{world}_{backend}"] = ranks
                log(f"dist: {world} ranks over {backend} on {card}, "
                    f"{wall:.1f} s for the group (start-up included)")
                for r in ranks:
                    a = r["render"]
                    runs = a["runs"]
                    log(f"dist:   rank {r['rank']}/{world} ({r['device']}) "
                        f"render: {a['pairs']} pairs in a {a['pair_array']}"
                        f"-pair array over {a['tiles']} tiles; two runs: "
                        f"forward " + " / ".join(
                            f"{x['fwd_ms']:.3f}" for x in runs)
                        + " ms, backward " + " / ".join(
                            f"{x['bwd_ms']:.3f}" for x in runs)
                        + f" ms, counters {runs[0]['counters']}, host "
                        f"syncs {[x['syncs'] for x in runs]}, grad rel L2 "
                        f"{json.dumps([x['grad_rel_l2'] for x in runs])}, "
                        f"image and depth bit-identical, launches "
                        f"{a['launches']}; collectives of a run: forward "
                        f"{_collective_summary(runs[1]['collectives']['forward'])}"
                        f", backward "
                        f"{_collective_summary(runs[1]['collectives']['backward'])}")
                    for k in launches:
                        launches[k] += a["launches"][k]
                    if "step" in r:
                        b = r["step"]
                        log(f"dist:   rank {r['rank']}/{world} mapping step "
                            f"(data, gauss) = (2, 2), {b['views']} views: "
                            f"{b['step_ms'][0]:.3f} / {b['step_ms'][1]:.3f} "
                            f"ms, loss {b['loss']} against {b['ref_loss']} "
                            f"(rel {b['loss_rel']:.3e}), xyz max abs "
                            f"{b['xyz_max_abs']:.3e}, n_dropped "
                            f"{b['n_dropped']}, two runs bit-identical, "
                            f"host syncs {b['syncs']}, launches "
                            f"{b['launches']}; collectives "
                            f"{_collective_summary(b['collectives'])}")
                        for k in launches:
                            launches[k] += b["launches"][k]
        for world in DIST_WORLDS:
            if torch.device(device).type == "cuda" and len(
                    backends[world]) == 1:
                log(f"dist: nccl at {world} ranks skipped: "
                    f"{torch.cuda.device_count()} card(s), nccl takes one "
                    f"rank a card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    log(f"dist: launches on the sharded paths {json.dumps(launches)}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    if not all(launches.values()):
        raise AssertionError(f"a kernel of the sharded paths was never "
                             f"launched: {launches}")
    return {"launches": launches, "groups": groups,
            "phase_s": time.perf_counter() - t_phase}


# --------------------------------------------------------------------------
# phases 15 and 16: the reference-scale tools
# --------------------------------------------------------------------------

# the gate's depth here, of the tool's 2,200 iterations: 8 of its 15
# densify/prune cycles, the 8th at the last iteration, and no opacity
# reset (the full run is the tool's own)
GATE_SMOKE_ITERS = 1100
GATE_EVAL_VIEWS = 4
# the JAX package's test bars (tests/test_quality_gate.py: PSNR 30, SSIM
# 0.85, kp contrast 5, 100,000 alive), each lowered to the tool's first
# 1,100-iteration run on an H100 (PSNR 20.77, SSIM 0.751, kp contrast 3.9,
# 100,168 alive; see PERF.md) less a margin of 2 dB, 0.03, 20 % and 10 %,
# which is lower for all four: iteration 1,100 densifies and prunes, so
# the held-out views score the map before any step repairs it (PSNR 38.54
# at iteration 852 of the same run, 38.61 at 2,200)
GATE_BARS = {"psnr": 18.77, "ssim": 0.721, "kp_contrast": 3.12,
             "n_alive": 90_151}
# refine_table's seeds a row here (the tool's default is 3)
TABLE_SEEDS = 1


def gate_phase(seed: int, device, card: str,
               map_iters: int = GATE_SMOKE_ITERS, bars: dict | None = None,
               **size) -> dict:
    """Phase 15: ``splatloc_tpu_torch.tools.quality_gate`` at full width
    (640x480, 60,000 GT Gaussians, 36 keyframes, capacity 205,440,
    kp_budget 2,048; ``size`` a CPU rehearsal's smaller one) to
    ``map_iters``, with fresh progress and checkpoint paths so it maps, and
    every kernel's launch count set to 0 just before and read just after;
    the launches, the bars, the drops (counted, none since the last check
    and none in the eval renders) and the three kernels against their
    plain versions on the last eval view."""
    from splatloc_tpu_torch.tools import quality_gate

    bars = GATE_BARS if bars is None else bars
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, mock.patch.dict(os.environ, {
            "SPLATLOC_GATE_LOG": str(Path(tmp) / "progress.jsonl"),
            "SPLATLOC_GATE_CKPT": str(Path(tmp) / "ckpt.npz")}):
        synced(device)
        reset_launches()
        run = quality_gate.run(n_eval=GATE_EVAL_VIEWS, map_iters=map_iters,
                               seed=seed, device=device, **size)
        synced(device)
        launches = read_launches()
        rows = [json.loads(x) for x in (Path(tmp) / "progress.jsonl")
                .read_text().splitlines()]
    res = run.result
    trainer = run.trainer
    eval_cfg = trainer.cfg.raster_config(device)
    eval_drops = [drop_counters(trainer.scene,
                                run.cam0.replace_pose(torch.from_numpy(w2c)),
                                eval_cfg) for _, _, w2c in run.evals]
    steps = trainer.cfg.window_size * res["iters"]
    want = {"fwd_pairwalk": steps + len(run.evals), "bwd_pairwalk": steps,
            "seg_reduce": steps, "pnp_refine": 0}
    info = {"result": res, "seconds": run.seconds,
            "gt_pairs_dropped": run.gt_dropped,
            "tail_pairs_dropped": run.tail_dropped,
            "eval_drop_counters": eval_drops,
            "peak_mem_gb": run.peak_mem_gb, "bars": bars,
            "visible_cap": trainer.cfg.visible_cap,
            "pair_cap_override": trainer.cfg.pair_cap_override,
            "capacity": trainer.scene.capacity,
            "launches": launches, "launches_expected": want}
    log(f"gate on {card}: " + json.dumps(info))
    if launches != want:
        raise AssertionError(f"gate launches {launches}, expected {want}")
    if res["resumed"] or res["iters"] != map_iters:
        raise AssertionError(f"the gate did not map to {map_iters}: {res}")
    if [r["phase"] for r in rows] != (["mapping"] + ["eval_view"]
                                      * len(run.evals) + ["final"]):
        raise AssertionError(f"progress rows {rows}")
    if not all(np.isfinite(res[k]) for k in ("psnr", "ssim", "kp_contrast")):
        raise AssertionError(f"non-finite gate scores: {res}")
    low = [k for k, bar in bars.items() if not res[k] >= bar]
    if low:
        raise AssertionError(f"gate below its bars on {low}: {res} "
                             f"(bars {bars})")
    # every drop is surfaced (counted in n_dropped_total and escalated at
    # the densify check) and bounded: none since the last check, none in
    # the held-out renders
    if run.tail_dropped or any(any(c) for c in eval_drops):
        raise AssertionError(f"pairs dropped after the last check "
                             f"({run.tail_dropped}) or in the eval renders "
                             f"({eval_drops})")
    _, _, w2c = run.evals[-1]
    errs, _, n_pairs = kernels_vs_plain(
        trainer.scene, run.cam0.replace_pose(torch.from_numpy(w2c)), seed)
    log("gate: kernels vs plain on the last eval view of the gate's map "
        + json.dumps({**errs, "pairs": n_pairs}))
    info["kernel_errs"] = errs
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"gate: phase wall {info['phase_s']:.1f} s")
    return info


def refine_table_phase(seed: int, device, card: str,
                       seeds: int = TABLE_SEEDS) -> dict:
    """Phase 16: ``splatloc_tpu_torch.tools.refine_table`` with ``seeds``
    seeds a row, every kernel's launch count set to 0 just before and read
    just after; every row's median final error within LOC_LIMITS' refined
    limit, and the three kernels against their plain versions on the
    table's scene at 160x120."""
    from splatloc_tpu_torch.tools import refine_table

    t_phase = time.perf_counter()
    synced(device)
    reset_launches()
    rows = refine_table.main(device=device, seeds=seeds)
    synced(device)
    launches = read_launches()
    log(f"refine_table on {card}: " + json.dumps(
        {"rows": rows, "launches": launches}))
    if not all(launches[k] for k in RASTER_KERNELS):
        raise AssertionError(f"a kernel was never launched by the table's "
                             f"refinements: {launches}")
    t_lim = LOC_LIMITS["match_median_t_m"] * 100
    r_lim = LOC_LIMITS["match_median_r_deg"]
    far = [r for r in rows if not (r["t_err_cm"] <= t_lim
                                   and r["r_err_deg"] <= r_lim)]
    if len(rows) != len(refine_table.ROWS) or far:
        raise AssertionError(f"refinement left rows past {t_lim} cm / "
                             f"{r_lim} deg: {far}")
    scene = refine_table.make_scene(np.random.default_rng(seed),
                                    device=device)
    errs, _, n_pairs = kernels_vs_plain(scene, refine_table.camera(device),
                                        seed)
    log("refine_table: kernels vs plain on the table's scene "
        + json.dumps({**errs, "pairs": n_pairs}))
    res = {"rows": rows, "launches": launches, "kernel_errs": errs,
           "phase_s": time.perf_counter() - t_phase}
    log(f"refine_table: phase wall {res['phase_s']:.1f} s")
    return res


# --------------------------------------------------------------------------
# phase 17: the query path at reference scale
# --------------------------------------------------------------------------

# the rehearsal's depth here, of the tool's 100 queries (its recorded runs
# take 40); everything else at the tool's width
REHEARSAL_SMOKE_QUERIES = 16
# the JAX tool's result keys, in its order (tools/eval_rehearsal.py:258-275)
REHEARSAL_KEYS = ("tool", "n_gaussians", "image", "n_train_views",
                  "n_queries", "db_render_s_total", "selection_5000_s",
                  "ms_superpoint", "ms_frustum_snap", "ms_decode",
                  "ms_hungarian", "ms_pnp", "ms_query_total",
                  "render_refine_s_steady", "pnp_solved", "finite")
# query 0 on the card against the port's CPU path: SuperPoint's dense
# scores (softmax probabilities near 1/65 after eight float32 convs summed
# in another order, TF32 off) and its descriptors at the key points both
# keep; the share of the card's valid key points the CPU run does not keep
# (a swap where two NMS survivors' scores lie within the scores' limit,
# at the 4,096th place or at the 0.005 threshold); the padded decode
# (CARD_CPU_LIMITS' decode: bf16 operands after float32 sums)
REHEARSAL_CPU_LIMITS = {"sp_scores": 1e-5, "sp_desc": 1e-4,
                        "sp_kp_moved": 1e-3,
                        "decode": CARD_CPU_LIMITS["decode"]}


def superpoint_card_cpu(sp_params, gray: np.ndarray, card_out: dict,
                        max_keypoints: int) -> dict:
    """``superpoint.extract`` on the port's CPU path against the card's
    output on one frame: the dense scores, the valid key points the two
    keep (as pixel sets) and the descriptors at the common ones."""
    from splatloc_tpu_torch.match import superpoint

    cpu = superpoint.extract({k: v.cpu() for k, v in sp_params.items()},
                             torch.from_numpy(gray.astype(np.float32)),
                             max_keypoints=max_keypoints)
    card = {k: v.cpu() for k, v in card_out.items()}

    def valid_kps(o):
        kp = o["keypoints"][o["valid"]].numpy().astype(np.int64)
        return {tuple(x): i for i, x in
                zip(np.nonzero(o["valid"].numpy())[0], kp)}
    kc, kh = valid_kps(card), valid_kps(cpu)
    common = sorted(set(kc) & set(kh))
    ic = [kc[x] for x in common]
    ih = [kh[x] for x in common]
    desc = (card["descriptors"][:, ic] - cpu["descriptors"][:, ih]).abs()
    return {"sp_scores": float((card["dense_scores"]
                                - cpu["dense_scores"]).abs().max()),
            "sp_desc": float(desc.max()) if common else 0.0,
            "sp_kp_moved": 1.0 - len(common) / max(len(kc), 1),
            "sp_valid": [len(kc), len(kh)],
            "sp_same_order": bool(torch.equal(card["keypoints"],
                                              cpu["keypoints"]))}


def rehearsal_card_extras(q0: dict, K, n_hypotheses: int, device,
                          info: dict) -> None:
    """Phase 17's card-only reports on query 0 (into ``info``): its
    auction's rounds, unconverged rows and host syncs, a device profile of
    the auction (busy and idle share against its unprofiled wall), and
    PnP's device memory on the kept matches."""
    from splatloc_tpu_torch.match import hungarian, pnp

    sim = hungarian._sim_matrix(
        torch.as_tensor(q0["qf"]["descriptors"], device=device),
        q0["feats"].T, 0.4)
    info["auction_q0"] = auction_syncs(sim)
    synced(device)
    t0 = time.perf_counter()
    hungarian.auction_assignment(sim, eps=1e-4)
    synced(device)
    info["auction_q0_profile"] = profile(
        lambda: hungarian.auction_assignment(sim, eps=1e-4),
        (time.perf_counter() - t0) * 1e3, 1, warm=True)
    log("rehearsal: query 0's auction " + json.dumps(info["auction_q0"])
        + "; its profile " + json.dumps(info["auction_q0_profile"]))
    keep, m = q0["keep"], q0["matches"]
    q2d = q0["qf"]["keypoints"][m[0][keep]].astype(np.float32)
    p3d = q0["pts3d"][m[1][keep]].astype(np.float32)
    synced(device)
    torch.cuda.reset_peak_memory_stats(device)
    base = torch.cuda.memory_allocated(device)
    pnp.solve_pnp_ransac(q2d, p3d, K, n_hypotheses=n_hypotheses,
                         device=device)
    info["pnp_q0_peak_mib"] = (torch.cuda.max_memory_allocated(device)
                               - base) / 2 ** 20
    log(f"rehearsal: PnP on query 0's {len(keep)} kept matches "
        f"{info['pnp_q0_peak_mib']:.1f} MiB of device memory past the "
        f"{base / 2 ** 20:.1f} MiB held")


def rehearsal_phase(seed: int, device, card: str,
                    n_queries: int = REHEARSAL_SMOKE_QUERIES) -> dict:
    """Phase 17: ``splatloc_tpu_torch.tools.eval_rehearsal`` (its ``run``)
    at full width (110,000 Gaussians, 640x480, 100 database views, 5,000
    of 30,000 key Gaussians selected, 4,096 key points, 256 hypotheses,
    3 refinements of 64 iterations a level) to ``n_queries`` queries,
    every kernel's launch count set to 0 just before and read just
    after. Fails unless the result has the
    JAX tool's keys, finite stage medians, every landmark, every query at
    PnP with no PnP call raising, the launches the refinements' records
    imply, the three kernels within their limits on database view 0, and
    query 0's SuperPoint and decode within REHEARSAL_CPU_LIMITS of the CPU
    path. Reports the solved count, the database renders' drops, query
    0's auction (rounds, unconverged rows, syncs, a device profile), PnP's
    peak memory, the kept matches that are pad rows, and the peak device
    memory."""
    from splatloc_tpu_torch.fields.decoder import decode
    from splatloc_tpu_torch.match import superpoint
    from splatloc_tpu_torch.tools import eval_rehearsal

    t_phase = time.perf_counter()
    per_query, q0 = [], {}

    def on_query(qi, rec):
        row = {"n_real": rec["n_real"], "n_valid": rec["qf"]["n_valid"]}
        if "matches" in rec:
            cols = rec["matches"][1][rec["keep"]]
            row.update(kept=len(cols), kept_pads=int((cols >= rec["n_real"])
                                                     .sum()),
                       sims_over=int((rec["sims"] > 0).sum()),
                       solved=bool(rec["pnp"] and rec["pnp"]["success"]))
        per_query.append(row)
        if qi == 0:
            q0.update(rec)

    synced(device)
    reset_launches()
    run = eval_rehearsal.run(n_queries=n_queries, device=device,
                             on_query=on_query)
    synced(device)
    launches = read_launches()
    res = run.result
    n_train, n_landmarks = res["n_train_views"], 5000
    infos = [r["info"] for r in run.refinements]
    iters = sum(int(lv["iters"]) for i in infos for lv in i["levels"])
    want = {"fwd_pairwalk": n_train + len(infos) + iters
            + sum(i["seed_evals"] + 2 for i in infos),
            "bwd_pairwalk": iters, "seg_reduce": iters,
            # two a RANSAC solve: every query with a sample's worth of
            # kept matches
            "pnp_refine": 2 * sum(q.get("kept", 0) >= 6 for q in per_query)}
    info = {"result": res, "seconds": run.seconds,
            "peak_mem_gb": run.peak_mem_gb, "landmarks": len(run.landmarks),
            "pnp_errors": run.pnp_errors,
            "refinements": [{"seconds": r["seconds"],
                             "seed_evals": r["info"]["seed_evals"],
                             "levels": r["info"]["levels"],
                             "guard_kept_start": r["info"][
                                 "guard_kept_start"]}
                            for r in run.refinements],
            "queries": per_query, "launches": launches,
            "launches_expected": want}
    log(f"rehearsal on {card}: " + json.dumps(info))
    if tuple(res) != REHEARSAL_KEYS:
        raise AssertionError(f"rehearsal result keys {list(res)}")
    stats = [k for k in REHEARSAL_KEYS if k.startswith(("ms_", "db_", "sel"))
             ] + ["render_refine_s_steady"]
    if not (res["finite"] is True
            and all(res[k] is not None and np.isfinite(res[k])
                    for k in stats)):
        raise AssertionError(f"rehearsal stage medians not finite: {res}")
    if len(run.landmarks) != n_landmarks:
        raise AssertionError(f"selection returned {len(run.landmarks)} of "
                             f"{n_landmarks} landmarks")
    if (run.pnp_errors or len(per_query) != n_queries
            or len(run.stages["pnp"]) != n_queries
            or any(q["n_real"] < 5 for q in per_query)):
        raise AssertionError(f"a query did not reach PnP or PnP raised: "
                             f"{run.pnp_errors}, {per_query}")
    if launches != want:
        raise AssertionError(f"rehearsal launches {launches}, expected "
                             f"{want}")

    # drops of the database renders (the tool's raster config), after
    rcfg = RasterConfig.for_device(device)
    drops = [drop_counters(run.scene, run.cam0.replace_pose(
        torch.from_numpy(run.frames[i]["w2c"])), rcfg)
        for i in range(n_train)]
    info["db_drops"] = {"views_dropping": sum(any(d) for d in drops),
                        "pairs_dropped": sum(d[0] for d in drops),
                        "pairs_truncated": sum(d[1] for d in drops),
                        "visible_dropped": sum(d[2] for d in drops)}
    log("rehearsal: database renders' drops " + json.dumps(info["db_drops"]))

    # the kernels against their plain versions on database view 0
    cam = run.cam0.replace_pose(torch.from_numpy(run.frames[0]["w2c"]))
    errs, _, n_pairs = kernels_vs_plain(run.scene, cam, seed)
    info["kernel_errs"] = errs
    log("rehearsal: kernels vs plain on database view 0 "
        + json.dumps({**errs, "pairs": n_pairs}))

    # query 0 on the card against the CPU path: SuperPoint, the decode
    gray0 = run.grays[0]
    card_out = superpoint.extract(run.sp_params,
                                  torch.as_tensor(gray0, device=device),
                                  max_keypoints=q0["qf"]["keypoints"]
                                  .shape[0])
    check = superpoint_card_cpu(run.sp_params, gray0, card_out,
                                q0["qf"]["keypoints"].shape[0])
    cpu_params = {"table": run.decoder_params["table"].cpu(),
                  "layers": [w.cpu() for w in
                             run.decoder_params["layers"]]}
    feats_cpu = decode(cpu_params, torch.from_numpy(q0["pts3d"]),
                       run.field_cfg)
    feats_cpu[q0["n_real"]:] = 0.0
    check["decode"] = float((q0["feats"].cpu() - feats_cpu).abs().max())
    info["card_cpu"] = check
    log("rehearsal: query 0 on the card vs the CPU path " + json.dumps(check)
        + f" (limits {json.dumps(REHEARSAL_CPU_LIMITS)})")
    bad = [k for k, lim in REHEARSAL_CPU_LIMITS.items()
           if not check[k] <= lim]
    if bad:
        raise AssertionError(f"query 0 differs from the CPU path on {bad}: "
                             f"{check}")

    rehearsal_card_extras(q0, run.frames[0]["K"],
                          eval_rehearsal.N_HYPOTHESES, device, info)
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"rehearsal: {res['pnp_solved']} of {n_queries} PnP solved (random "
        f"weights); phase wall {info['phase_s']:.1f} s")
    return info


# --------------------------------------------------------------------------
# phase 18: the benchmark and profiling programs
# --------------------------------------------------------------------------

# each tool's depth here: bench's 100 iterations a stage, bench_pose's 50
# and profile_map's 6 steps are the tools' own; bench_refine 1 of its 5
# seeds; profile_bench and profile_chain 6 iterations (their own 6 and 10)
BENCH_ITERS = 100
POSE_ITERS = 50
BENCH_REFINE_SEEDS = 1
PROFILE_ITERS = 6
MAP_PROFILE_ALIVE = 130_000
MAP_PROFILE_ITERS = 6
# the JAX programs' result keys, in their order (bench.py:370,
# bench_pose.py:59-64, tools/bench_refine.py:86-99,
# tools/profile_bench.py:125-131, tools/profile_chain.py:177-183,
# tools/profile_map.py:100-127)
BENCH_KEYS = {
    "bench": ("metric", "value", "unit", "vs_baseline"),
    "bench_pose": ("metric", "value", "unit", "vs_baseline"),
    "bench_refine": ("metric", "median_t_cm", "median_r_deg", "start_t_cm",
                     "start_r_deg", "t_reduction_x", "r_reduction_x",
                     "iters_per_s", "n_seeds"),
    "profile_bench": ("tool", "ms_per_iter", "mpix_s", "device_op_ms",
                      "device_idle_ms"),
    "profile_chain": ("tool", "ms_per_iter", "mpix_s", "device_busy_ms",
                      "device_idle_ms"),
    "profile_map": ("tool", "ms_per_step", "it_s", "n_alive", "capacity",
                    "device_op_ms"),
}
# the 64x48 bench step on the card against the CPU path: the render
# limit on the loss, the gradient limit (relative L2) on each of the five
# gradients, float32 slabs on both (as the card tests hold rasterize)
BENCH_CPU_LIMITS = {"loss": 5e-5, "grad_rel_l2": 1e-3}


def check_line(name: str, line: dict) -> None:
    """The JAX program's keys in their order and every number finite
    (bench_pose's vs_baseline is the JAX program's null)."""
    if tuple(line) != BENCH_KEYS[name]:
        raise AssertionError(f"{name} line keys {list(line)}")
    for k, v in line.items():
        if name == "bench_pose" and k == "vs_baseline":
            if v is not None:
                raise AssertionError(f"bench_pose vs_baseline {v}")
        elif not isinstance(v, str) and not (v is not None
                                             and np.isfinite(v)):
            raise AssertionError(f"{name} {k} not finite: {line}")


def bench_card_cpu(device) -> dict:
    """One 64x48 ``bench`` step (2,000 Gaussians) on the card against the
    port's CPU path: the loss and the five gradients."""
    from splatloc_tpu_torch.tools import bench

    old = hopper_raster.GRAD_SLAB_DTYPE
    hopper_raster.GRAD_SLAB_DTYPE = torch.float32
    try:
        res = {}
        for dev in ("cpu", device):
            cam, args, tgt = bench.make_inputs(48, 64, 2000, dev)
            leaves = [a.clone().requires_grad_(True) for a in args]
            loss = bench.loss_fn(leaves, cam, bench.bench_config(), tgt)
            grads = torch.autograd.grad(loss, leaves)
            res[str(dev)] = (float(loss.detach()), [g.cpu() for g in grads])
    finally:
        hopper_raster.GRAD_SLAB_DTYPE = old
    (lc, gc), (lh, gh) = res[str(device)], res["cpu"]
    d = {"loss": abs(lc - lh), "grad_rel_l2": max(
        rel_l2(a, b) for a, b in zip(gc, gh))}
    if not all(bool(torch.isfinite(g).all()) for g in gc):
        raise AssertionError("the card's bench gradients are not finite")
    bad = [k for k, lim in BENCH_CPU_LIMITS.items() if not d[k] <= lim]
    log("bench: the 64x48 step on the card vs the CPU path "
        + json.dumps(d) + f" (limits {json.dumps(BENCH_CPU_LIMITS)})")
    if bad:
        raise AssertionError(f"the bench step differs from the CPU path on "
                             f"{bad}: {d}")
    return d


def refine_sized_caps(sc, device) -> dict:
    """bench_refine's seed 0 on its scene with the pair array sized for the
    target view (no pair dropped), beside the tool's default caps, whose
    target drops pairs (ROADMAP C)."""
    from splatloc_tpu_torch.match.localize import refine_pose
    from splatloc_tpu_torch.tools import bench_refine

    cam = bench_refine.camera(WIDTH, HEIGHT, device)
    cfg = size_pair_array(sc, [cam], RasterConfig.for_device(device))
    with torch.no_grad():
        gt = render(sc, cam, cfg)["render"]
    w2c0 = transforms.se3_exp(torch.from_numpy(
        bench_refine.start_twist(0)).to(device)).cpu().numpy()
    dxi, info = refine_pose(sc, cam, w2c0, gt, iters=100, raster_cfg=cfg)
    w2c1 = (transforms.se3_exp(dxi)
            @ torch.from_numpy(w2c0).to(device)).cpu().numpy()
    t, r = bench_refine._pose_err(w2c1, np.eye(4))
    return {"target_drops": drop_counters(sc, cam, cfg), "t_cm": t * 100,
            "r_deg": r, "iters": int(info["iters"]),
            "guard_kept_start": info["guard_kept_start"]}


def bench_phase(seed: int, device, card: str) -> dict:
    """Phase 18: the six benchmark and profiling tools through their
    ``run``/``main`` at full width, each with every kernel's launch count
    set to 0 just before and read just after; fails unless each line has
    the JAX program's keys and finite numbers, bench's stages dropped no
    pair, the launches are exactly the renders each tool issues, the three
    kernels agree with their plain versions on profile_map's trainer view,
    and the 64x48 bench step on the card agrees with the CPU path."""
    from splatloc_tpu_torch.tools import (bench, bench_pose, bench_refine,
                                          profile_bench, profile_chain,
                                          profile_map)

    t_phase = time.perf_counter()
    info, launches = {}, {}

    def counted(name, fn):
        synced(device)
        reset_launches()
        t0 = time.perf_counter()
        out = fn()
        synced(device)
        launches[name] = read_launches()
        info[name] = {"wall_s": time.perf_counter() - t0,
                      "launches": launches[name]}
        return out

    def expect(name, want):
        # none of the tools runs PnP
        want = {"pnp_refine": 0, **want}
        info[name]["launches_expected"] = want
        if launches[name] != want:
            raise AssertionError(f"{name} launches {launches[name]}, "
                                 f"expected {want}")

    def report(name, line):
        check_line(name, line)
        info[name]["line"] = line
        log(f"bench: {name} on {card}: {json.dumps(line)}")

    # bench: stages A, B and C; per stage a first step, a drop check (a
    # forward), a warm step and BENCH_ITERS steps
    b = counted("bench", lambda: bench.run(device=device, iters=BENCH_ITERS))
    report("bench", {k: b["result"][k] for k in bench.RESULT_KEYS})
    info["bench"].update(stages=b["stages"], kept=b["result"]["stage"])
    log("bench: stages " + json.dumps(b["stages"]))
    if any(r["n_dropped"] for r in b["stages"].values()):
        raise AssertionError(f"a bench stage dropped pairs: {b['stages']}")
    n = len(bench.STAGES)
    expect("bench", {"fwd_pairwalk": n * (3 + BENCH_ITERS),
                     "bwd_pairwalk": n * (2 + BENCH_ITERS),
                     "seg_reduce": n * (2 + BENCH_ITERS)})

    # bench_pose: the target, a warm step and POSE_ITERS steps
    p = counted("bench_pose", lambda: bench_pose.run(device=device,
                                                     iters=POSE_ITERS))
    report("bench_pose", p["result"])
    info["bench_pose"]["target_drops"] = p["drops"]
    expect("bench_pose", {"fwd_pairwalk": 2 + POSE_ITERS,
                          "bwd_pairwalk": 1 + POSE_ITERS,
                          "seg_reduce": 1 + POSE_ITERS})

    # bench_refine: the target, then per seed refine_pose's renders (a
    # forward a seed, an iteration and each of the guard's two; a
    # backward and a reduction an iteration)
    seeds = []
    r = counted("bench_refine", lambda: bench_refine.main(
        BENCH_REFINE_SEEDS, device=device,
        on_seed=lambda s, rec: seeds.append(rec["info"])))
    report("bench_refine", r)
    iters = [int(i["iters"]) for i in seeds]
    if iters != [sum(lv["iters"] for lv in i["levels"]) for i in seeds]:
        raise AssertionError(f"refine_pose's iterations {seeds}")
    expect("bench_refine", {
        "fwd_pairwalk": 1 + sum(i["seed_evals"] + 2 for i in seeds)
        + sum(iters), "bwd_pairwalk": sum(iters),
        "seg_reduce": sum(iters)})
    sc = bench_refine.make_scene(100_000, device)
    info["bench_refine"]["target_drops"] = drop_counters(
        sc, bench_refine.camera(WIDTH, HEIGHT, device),
        RasterConfig.for_device(device))
    info["bench_refine"]["sized_caps_seed0"] = refine_sized_caps(sc, device)
    log("bench: bench_refine's seed 0 with a pair array sized for the "
        "target (outside the counted run) "
        + json.dumps(info["bench_refine"]["sized_caps_seed0"]))
    del sc

    # profile_bench: a first step, a warm step, PROFILE_ITERS timed and
    # PROFILE_ITERS traced
    pb = counted("profile_bench", lambda: profile_bench.run(
        PROFILE_ITERS, device=device))
    report("profile_bench", pb["result"])
    info["profile_bench"]["gaps"] = pb["summary"]["gaps"][:6]
    expect("profile_bench", raster_only(2 + 2 * PROFILE_ITERS))

    # profile_chain: a first step, a drop check, a warm step, then
    # PROFILE_ITERS timed and PROFILE_ITERS traced
    pc = counted("profile_chain", lambda: profile_chain.run(
        PROFILE_ITERS, device=device))
    report("profile_chain", pc["result"])
    info["profile_chain"].update(gaps=pc["summary"]["gaps"][:6],
                                 pair_need=pc["pair_need"])
    log(f"bench: profile_chain device busy "
        f"{pc['summary']['busy_ms']} ms, idle {pc['summary']['idle_ms']} ms "
        f"an iteration; largest gaps {json.dumps(pc['summary']['gaps'][:6])}")
    expect("profile_chain", {"fwd_pairwalk": 3 + 2 * PROFILE_ITERS,
                             "bwd_pairwalk": 2 + 2 * PROFILE_ITERS,
                             "seg_reduce": 2 + 2 * PROFILE_ITERS})

    # profile_map: map(1), map(MAP_PROFILE_ITERS) timed and traced, each
    # step a window of renders
    pm = counted("profile_map", lambda: profile_map.run(
        MAP_PROFILE_ALIVE, MAP_PROFILE_ITERS, device=device))
    report("profile_map", pm["result"])
    trainer = pm["trainer"]
    expect("profile_map", raster_only(trainer.cfg.window_size
                                      * (1 + 2 * MAP_PROFILE_ITERS)))
    rcfg = trainer.cfg.raster_config()
    views = [trainer.camera.replace_pose(trainer.frames.w2c[i])
             for i in range(trainer.frames.n)]
    drops = [drop_counters(trainer.scene, cam, rcfg) for cam in views]
    info["profile_map"].update(
        visible_cap=trainer.cfg.visible_cap,
        pair_cap_override=trainer.cfg.pair_cap_override,
        alive=int(trainer.scene.num_alive), keyframe_drops=drops,
        top_ops=pm["summary"]["ops"][:8])
    log("bench: drops (n_dropped, n_trunc, n_vis_dropped) at default caps: "
        f"bench_pose's target {info['bench_pose']['target_drops']}, "
        f"bench_refine's target {info['bench_refine']['target_drops']}, "
        f"profile_map's keyframe views {drops}")

    # the kernels against their plain versions on profile_map's last
    # keyframe view of the filled scene, under the trainer's caps
    with torch.no_grad():
        walk_args, C, pr = walk_inputs(trainer.scene, views[-1], rcfg)
        got = hopper_raster.fwd_pairwalk(*walk_args, C, rcfg)
        ref = hopper_raster.fwd_pairwalk_plain(*walk_args, C, rcfg)
        synced(device)
        mf = compare_walk(got, ref, C)
        _, _, _, errs = check_backward(walk_args, got, pr, C, rcfg, seed,
                                       trainer.cfg.width, trainer.cfg.height)
    errs = {"fwd_pairwalk": mf["max_abs_err"], **errs}
    log("bench: kernels vs plain on profile_map's view "
        + json.dumps({**errs, "pairs": int(walk_args[2].sum()),
                      "pair_array": int(walk_args[0].shape[1])}))
    del trainer, pm, walk_args, got, ref

    info["card_cpu"] = bench_card_cpu(device)
    total = {k: sum(v[k] for v in launches.values())
             for k in ("fwd_pairwalk", "bwd_pairwalk", "seg_reduce")}
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"bench: phase wall {info['phase_s']:.1f} s; tool walls "
        + json.dumps({k: round(v["wall_s"], 2) for k, v in info.items()
                      if isinstance(v, dict) and "wall_s" in v}))
    return {"launches": total, "kernel_errs": errs, "info": info,
            "phase_s": info["phase_s"]}



# --------------------------------------------------------------------------
# 19. pnp: the Gauss-Newton kernel against its plain version on the
# benchmark's localize traffic
# --------------------------------------------------------------------------

PNP_CELL = "localize.replica_room0"
# seeds of that cell at which the plain fits themselves miss its pose check
# on some query: 627921043 (query 81) and 1800000413 (queries 60 and 84)
PNP_SEEDS = (627921043, 1800000413)
# the kernel's final world-to-camera pose against the plain version's
PNP_LIMITS = {"r": 1e-5, "t": 1e-5}
# NVIDIA H100 SXM data sheet: float64 outside the tensor cores
FP64_OPS_PER_S = 34e12
# the operations of a Gauss-Newton fit: each iteration, on a weighted
# pair, float32 for the pose and its 6 tangents applied to the point, the
# projection and the residual and Jacobian rows, and float64 for the 27
# sums (two exact products and two additions each); on every pair, once a
# fit, float32 for its reprojection error under the starting pose (its
# weight) and once more under the fitted pose (the score or the inliers)
GN_F32_OPS_PER_PAIR = 170
GN_F64_OPS_PER_PAIR = 108
GN_F32_OPS_PER_ERR = 30


def gn_bound_ms(n_weighted: int, n_poses: int, n_pairs: int,
                iters: int) -> tuple[float, str, dict]:
    """The least time the card could take for one fit launch: its float32
    and float64 operations each over their rate, the larger of the two
    (the inputs are tens of KB). ``n_weighted`` is the weighted pairs
    summed over the poses."""
    f32 = (iters * n_weighted * GN_F32_OPS_PER_PAIR
           + 2 * n_poses * n_pairs * GN_F32_OPS_PER_ERR)
    f64 = iters * n_weighted * GN_F64_OPS_PER_PAIR
    t32, t64 = f32 / FP32_OPS_PER_S * 1e3, f64 / FP64_OPS_PER_S * 1e3
    return max(t32, t64), ("f64 operations" if t64 >= t32
                           else "f32 operations"), {
        "f32_ops": f32, "f64_ops": f64, "f32_ms": t32, "f64_ms": t64}


def on_host(solved) -> dict:
    """``pnp._solve_core``'s outputs (the fitted world-to-camera pose, the
    inliers, their count, the winning hypothesis) on the host."""
    R, t, inl, n, best = solved
    return {"R": R.cpu().numpy(), "t": t.cpu().numpy(),
            "inl": inl.cpu().numpy(), "n": int(n), "best": int(best)}


def pnp_pose_gap(pre: dict, q: int, pairs, side: dict,
                 min_inliers: int = 5) -> float | None:
    """portbench's ``pose_gap_px`` of one side's pose on query ``q``'s
    pairs: against the reference's PnP, over the database frustum's
    landmarks; inf where one side has no pose, None where neither has."""
    from portbench.reference import localize as ref
    inp, sel = pre["inp"], pre["sel"]
    db = inp.db[q % len(inp.db)].astype(np.float64)
    inside, _ = ref.frustum(sel, db, inp.K, inp.W, inp.H)
    rp = ref.pnp(*pairs, inp.K, np.random.default_rng([pre["seed"], 17, q]),
                 start=(db[:3, :3], db[:3, 3]))
    mp = (None if side["n"] < min_inliers else
          (side["R"].astype(np.float64), side["t"].astype(np.float64)))
    if rp is None or mp is None:
        return None if rp is None and mp is None else float("inf")
    return ref.pose_gap_near(mp, rp, *pairs, inp.K, sel[inside])


def pnp_phase(seed: int, device, card: str) -> dict:
    """Phase 19: the benchmark's localize traffic (cell PNP_CELL) at
    ``seed``: its set-up, then each of its queries once through the
    Localizer, whose PnP runs the kernel, with every kernel's launch count
    set to 0 just before and read just after the query; the Localizer's
    own RANSAC solve (``pnp._solve_core``'s inputs and outputs, recorded)
    against the plain version's on the same inputs and draws. Fails unless
    the kernel launches exactly twice a solve and the two sides agree on
    every query: the same winning hypothesis, the same inliers and count,
    the pose within PNP_LIMITS. The message names the queries that differ
    with both sides' pose gap against the benchmark's reference. Reports
    the Localizer's PnP stage ms beside the plain solve's ms,
    and the two launches' device ms (host-ahead) beside their bound and
    the plain fits' ms (host-paced) on the query with the most pairs."""
    from portbench import harness
    from portbench.generators import localize as gen
    from splatloc_tpu_torch.core.precision import full_float32

    t_phase = time.perf_counter()
    kernel, plain = pnp.gauss_newton_fit, pnp.gauss_newton_fit_plain
    core = pnp._solve_core
    pre = gen.prepare(harness.find_cell(PNP_CELL), seed, device)
    loc = pre["loc"]
    solves = []

    def recorded(*args):
        out = core(*args)
        solves.append((args, out))
        return out

    rows, diffs, worst, big = [], [], {"r": 0.0, "t": 0.0}, None
    launches = dict.fromkeys(read_launches(), 0)
    for q in range(len(pre["inp"].queries)):
        loc.cur, solves[:] = {}, []
        reset_launches()
        with mock.patch.object(pnp, "_solve_core", recorded):
            loc.localize({}, f"q{q}")
        got = read_launches()
        launches = {k: n + got[k] for k, n in launches.items()}
        if got["pnp_refine"] != 2 * len(solves) or len(solves) > 1:
            raise AssertionError(f"pnp: query {q}: {len(solves)} solves, "
                                 f"launches {got}")
        if not solves:
            continue
        args, out = solves[0]
        k = on_host(out)
        synced(device)
        t0 = time.perf_counter()
        with mock.patch.object(pnp, "gauss_newton_fit", plain):
            p = on_host(core(*args))
        p["ms"] = (time.perf_counter() - t0) * 1e3
        k["ms"] = loc.last_stages["pnp"] * 1e3
        dr = float(np.abs(k["R"] - p["R"]).max())
        dt = float(np.abs(k["t"] - p["t"]).max())
        worst = {"r": max(worst["r"], dr), "t": max(worst["t"], dt)}
        rows.append({"q": q, "pairs": loc.cur["pairs"], "kernel": k,
                     "plain": p})
        if big is None or args[0].shape[0] > big[1][0].shape[0]:
            big = (q, args[:5])
        same = (k["best"] == p["best"] and k["n"] == p["n"]
                and np.array_equal(k["inl"], p["inl"])
                and dr <= PNP_LIMITS["r"] and dt <= PNP_LIMITS["t"])
        if not same:
            diffs.append({"q": q, "best": [k["best"], p["best"]],
                          "inliers": [k["n"], p["n"]], "r": dr, "t": dt})
    loc.untap()
    for d in diffs:
        row = next(r for r in rows if r["q"] == d["q"])
        d["pose_gap_px"] = [pnp_pose_gap(pre, d["q"], row["pairs"],
                                         row[s]) for s in ("kernel", "plain")]
    n_solved = len(rows)
    log(f"pnp: seed {seed}, {n_solved} queries solved, the Localizer's "
        f"launches {json.dumps(launches)}; winners, inliers or poses differ "
        f"on {len(diffs)}: " + json.dumps(diffs)
        + f"; worst pose difference {json.dumps(worst)}")
    if diffs:
        raise AssertionError(f"pnp: the kernel and the plain fits differ "
                             f"on {len(diffs)} queries (pose_gap_px: "
                             f"kernel, plain): {json.dumps(diffs)}")

    # the two launches on the query with the most pairs
    p2, p3, valid, pri, thr = big[1]
    with full_float32():
        R, t, ok = pnp._hypotheses(p2, p3, valid, pri, 6)
        Rh, th, score = kernel(R, t, p2, p3, valid, thr, 5, ok=ok)
        best = torch.argmax(score)
        err = pnp._reproj_errors(R, t, p2, p3)
        w_loose = int(((err < 3.0 * thr) & valid).sum())
        err = pnp._reproj_errors(Rh[best:best + 1], th[best:best + 1], p2, p3)
        w_strict = int(((err < thr) & valid).sum())
        M, B = p2.shape[0], R.shape[0]
        timing = {
            "pairs": M, "hypotheses": B,
            "weighted": [w_loose, w_strict],
            "hypotheses_ms": event_ms(
                lambda: kernel(R, t, p2, p3, valid, thr, 5, ok=ok), 20),
            "final_ms": event_ms(
                lambda: kernel(Rh, th, p2, p3, valid, thr, 10, best=best),
                20),
            "plain_hypotheses_ms": event_ms(
                lambda: plain(R, t, p2, p3, valid, thr, 5, ok=ok), 3, 1,
                host_ahead=False),
            "plain_final_ms": event_ms(
                lambda: plain(Rh, th, p2, p3, valid, thr, 10, best=best), 3,
                1, host_ahead=False)}
    timing["bound_hypotheses"] = gn_bound_ms(w_loose, B, M, 5)
    timing["bound_final"] = gn_bound_ms(w_strict, 1, M, 10)
    solve_ms = {"localizer_pnp_stage": float(np.median(
        [r["kernel"]["ms"] for r in rows])), "plain_solve": float(np.median(
            [r["plain"]["ms"] for r in rows]))}
    log(f"pnp: on {card}, query {big[0]}'s {M} pairs: " + json.dumps(timing)
        + "; median ms " + json.dumps(solve_ms))
    del loc, pre
    return {"seed": seed, "launches": launches, "solved": n_solved,
            "worst": worst, "timing": timing, "solve_ms": solve_ms,
            "phase_s": time.perf_counter() - t_phase}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_script = time.perf_counter()

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
    del room

    # 11. localize: the third main path, counts set to 0 just before, read
    # just after (inside localize_phase)
    t11 = time.perf_counter()
    loc = localize_phase(args.seed, dev, card)
    tmp = loc.pop("tmp")
    try:
        localize_extras(loc.pop("session"), loc, card)
        log(f"localize: phase wall {time.perf_counter() - t11:.1f} s "
            f"(the counted run and its checks {loc['phase_s']:.1f} s)")

        # 12. map: the mapping CLI on phase 11's dataset, counts set to 0
        # just before, read just after (inside map_phase)
        mapped = map_phase(tmp, args.seed, dev, card)
        log(f"map: phase wall {mapped['phase_s']:.1f} s; phase 11's "
            f"medians beside it: PnP {loc['median_m_deg']['pnp']}, refined "
            f"{loc['median_m_deg']['refined']} (m, deg)")

        # 13. protocol: every CLI from phase 11's frames to a replay,
        # counts set to 0 just before, read just after (inside
        # protocol_phase)
        proto = protocol_phase(tmp, args.seed, dev, card)
        log(f"protocol: phase wall {proto['phase_s']:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 14. dist: the sharded render and mapping step in groups of 2 and 4
    # ranks on the card, counts set to 0 just before each rank's runs and
    # read just after (inside dist_phase's ranks)
    sharded = dist_phase(scene, cams[0], cfg, args.seed, dev, card)

    # 15. gate: the port's quality gate at full width, counts set to 0
    # just before, read just after (inside gate_phase)
    gate = gate_phase(args.seed, dev, card)

    # 16. refine_table: the refinement basin table, counts set to 0 just
    # before, read just after (inside refine_table_phase)
    table = refine_table_phase(args.seed, dev, card)

    # 17. rehearsal: the query path at reference scale, counts set to 0
    # just before, read just after (inside rehearsal_phase)
    rehearsal = rehearsal_phase(args.seed, dev, card)

    # 18. bench: the benchmark and profiling tools at full width, counts
    # set to 0 just before, read just after each tool (inside bench_phase)
    benched = bench_phase(args.seed, dev, card)

    # 19. pnp: the Gauss-Newton kernel against its plain version on the
    # benchmark's localize traffic at each of PNP_SEEDS (inside pnp_phase)
    pnp_runs = [pnp_phase(s, dev, card) for s in PNP_SEEDS]

    paths = {"serve": launches, "train": train["launches"],
             "localize": loc["launches"], "map": mapped["launches"],
             "protocol": proto["launches"], "dist": sharded["launches"],
             "gate": gate["launches"], "refine_table": table["launches"],
             "rehearsal": rehearsal["launches"],
             "bench": benched["launches"],
             "pnp": {k: sum(r["launches"][k] for r in pnp_runs)
                     for k in pnp_runs[0]["launches"]}}

    def launched(k):
        return {"launches": sum(p.get(k, 0) for p in paths.values()),
                "launches_by_path": {n: p.get(k, 0)
                                     for n, p in paths.items()}}

    # the worst error against the plain version over phases 5, 8, 9, 11,
    # 12, 13, 15, 16, 17 and 18
    checked = (train, loc, mapped, proto, gate, table, rehearsal, benched)
    m["max_abs_err"] = max(m["max_abs_err"],
                           *(p["kernel_errs"]["fwd_pairwalk"]
                             for p in checked))
    for k in ("bwd_pairwalk", "seg_reduce"):
        bwd[k]["max_abs_err"] = max(bwd[k]["max_abs_err"],
                                    *(p["kernel_errs"][k] for p in checked))
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
        # no Pallas kernel: the JAX package's PnP is jnp code
        {"name": "pnp_refine", "route": "cuda",
         "source": src + "pnp_refine.cu", "replaces": None,
         **launched("pnp_refine"),
         "max_pose_diff": {k: max(r["worst"][k] for r in pnp_runs)
                           for k in PNP_LIMITS},
         **{k: pnp_runs[0]["timing"][k] for k in (
             "hypotheses_ms", "final_ms", "plain_hypotheses_ms",
             "plain_final_ms")},
         "bound_ms": [pnp_runs[0]["timing"][k][0] for k in (
             "bound_hypotheses", "bound_final")],
         "library_ms": None},
    ]
    log(f"chip_smoke: {time.perf_counter() - t_script:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(card)
    # the run uses one device, cuda:0, whatever else the host shows
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
