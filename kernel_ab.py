"""A/B of the port's kernels against other builds of their sources, on the
same inputs, in one run on one CUDA card.

A build is a directory holding the pair walks' sources (``fwd_pairwalk.cu``
and ``bwd_pairwalk.cu`` with the ``pair_power.cuh`` they include), the
reduction's (``seg_reduce.cu``), or both. The package's own sources
(``splatloc_tpu_torch/csrc``) are the build named ``new``; ``--ref
NAME=DIR`` adds another, for example an earlier commit's sources taken out
with git into the git-ignored ``build/``:

    mkdir -p build/ab_src/old
    for f in fwd_pairwalk.cu bwd_pairwalk.cu pair_power.cuh seg_reduce.cu; do
      git show <commit>:splatloc_tpu_torch/csrc/$f > build/ab_src/old/$f
    done
    python3 kernel_ab.py --ref old=build/ab_src/old --ablations --train

``--ablations`` adds builds of the package's sources with one design
choice undone each (ABLATIONS below), made by exact text replacements in a
copy under ``build/ab/``; such a build compiles only the kernels its edits
touch. Every build is compiled with the package's nvcc flags, loaded with
ctypes and launched through the same C functions as the package's wrappers.

Walks: on view 0 of ``chip_smoke.py``'s serve scene (100,000 Gaussians,
640x480, C = 4) it checks every build's forward output bit for bit against
``new``'s and its backward slabs (bf16 and f32) against
``bwd_pairwalk_plain`` within ``chip_smoke``'s limits, and two launches of
each build's backward for bitwise equality; times every build host-ahead
(``chip_smoke.event_ms``, the mean of ``--reps`` launches) in the order
A B ... B A, so that each build is timed twice, once early and once late,
``new`` also host-paced; and times ``new`` on the longest tenth of the
tiles alone against the rest (``split``).

Reduction: timed whole, from ``pair_idx`` to the [K, rows] result. A
``seg_reduce.cu`` that exports ``seg_reduce_scratch_ints`` is the sort-free
path (the package's interface since it dropped the sort); one that does
not is the earlier sorted path (a stable ``torch.sort`` of the pair ids,
two casts and a cumsum, then its kernel). On serve view 0's bf16 slab and,
with ``--train``, on the last keyframe's view of the trainer that
``chip_smoke.py`` phase 9 runs (under its final caps), with the slab's
unwritten tail NaN, and with ``--long-run N`` on a synthetic input of
serve view 0's size whose rank 0 emits N pairs (past the kernel's bucket of
4,096: its scan path): every build against ``seg_reduce_plain`` (relative L2
``chip_smoke.SEG_TOL``, the same zero rows) and two launches bit for bit,
then host-ahead times in the order A B ... B A, beside ``chip_smoke``'s
timing of the package's path (host-paced too), its plain version, the
``index_add_`` and ``torch.segment_reduce`` yardsticks and the bounds.

Prints one JSON line per build, the card's ``nvidia-smi`` line, and a
summary line; exits with 1 if a check fails.

Run from the repository root:  python3 kernel_ab.py [--ref NAME=DIR ...]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from splatloc_tpu_torch import build
from splatloc_tpu_torch.raster import RasterConfig, hopper_raster, pairs
from splatloc_tpu_torch.train.mapping import MappingTrainer

REPO = Path(__file__).resolve().parent
AB_DIR = REPO / "build" / "ab"
WALK_FILES = ("fwd_pairwalk.cu", "bwd_pairwalk.cu", "pair_power.cuh")
SEG_FILE = "seg_reduce.cu"
FILES = WALK_FILES + (SEG_FILE,)
# kernel -> its source
KERNELS = {"fwd": "fwd_pairwalk.cu", "bwd": "bwd_pairwalk.cu",
           "seg": SEG_FILE}
# Each ablation undoes one design choice of the package's kernels by exact
# text replacements (file, old, new); each `old` must occur exactly once.
ABLATIONS = {
    # forward: one pixel per thread (256 threads for a 16x16 tile)
    "pix1": [("fwd_pairwalk.cu", "constexpr int PIX = 2;",
              "constexpr int PIX = 1;")],
    # backward: two pixels per thread for 16x16 tiles too (128 threads)
    "pix2": [("bwd_pairwalk.cu",
              "int pix_for(int ts) { return ts * ts <= 256 ? 1 : 2; }",
              "int pix_for(int ts) { return 2; }")],
    # forward: one pair per evaluation step
    "unroll1": [("fwd_pairwalk.cu", "constexpr int UNROLL = 2;",
                 "constexpr int UNROLL = 1;")],
    # stages of 32 and of 128 pairs
    "stage32": [("fwd_pairwalk.cu", "constexpr int STAGE = 64;",
                 "constexpr int STAGE = 32;"),
                ("bwd_pairwalk.cu", "constexpr int STAGE = 64;",
                 "constexpr int STAGE = 32;")],
    "stage128": [("fwd_pairwalk.cu", "constexpr int STAGE = 64;",
                  "constexpr int STAGE = 128;"),
                 ("bwd_pairwalk.cu", "constexpr int STAGE = 64;",
                  "constexpr int STAGE = 128;")],
    # no alpha_cut: every pixel runs expf and the alpha test
    "no_alpha_cut": [("pair_power.cuh",
                      "if (!(op > 0.f) || !(alpha_min > 0.f)) "
                      "return -INFINITY;",
                      "return -INFINITY;")],
    # backward: every warp evaluates every pair down from jhi's chunk end
    "no_warp_skip": [("bwd_pairwalk.cu", "if (pos <= warp_last) {",
                      "if (true) {")],
    # backward: one five-level shuffle tree per value instead of the
    # transpose-reduce
    "value_trees": [("bwd_pairwalk.cu",
                     "x = warp_transpose_sum<NV>(v, lane);",
                     "for (int i2 = 0; i2 < NV; ++i2) { float y = v[i2]; "
                     "for (int o = 16; o > 0; o >>= 1) "
                     "y += __shfl_xor_sync(FULL, y, o); "
                     "if (i2 == sum_idx) x = y; }")],
    # tiles launched from tile 400 on (the serve view's longest tiles
    # first), wrapping around
    "rotate400": [("fwd_pairwalk.cu", "const int t = blockIdx.x;",
                   "const int t = (blockIdx.x + 400) % gridDim.x;"),
                  ("bwd_pairwalk.cu", "const int t = blockIdx.x;",
                   "const int t = (blockIdx.x + 400) % gridDim.x;")],
    # backward: the per-pair sums of the warp partials by one warp
    "finalize_one_warp": [("bwd_pairwalk.cu",
                           "for (int e4 = tid; e4 < n4; e4 += blockDim.x) {",
                           "for (int e4 = tid; e4 < n4 && tid < 32; "
                           "e4 += 32) {")],
    # reduction: every rank with pairs summed by a whole warp (one rank per
    # warp at a time, as the sorted path's kernel)
    "seg_warp_per_rank": [(SEG_FILE, "constexpr int SHORT_RUN = 32;",
                           "constexpr int SHORT_RUN = 0;")],
    # reduction: runs past 8 pairs by a warp (the first design)
    "seg_short8": [(SEG_FILE, "constexpr int SHORT_RUN = 32;",
                    "constexpr int SHORT_RUN = 8;")],
    # reduction: every run summed by one group of lanes, however long
    "seg_groups_only": [(SEG_FILE, "constexpr int SHORT_RUN = 32;",
                         "constexpr int SHORT_RUN = 1 << 30;")],
    # reduction: one pair position per fill thread
    "seg_fill1": [(SEG_FILE, "constexpr int FILL_PER_THREAD = 4;",
                   "constexpr int FILL_PER_THREAD = 1;")],
    # reduction: one row load in flight per lane
    "seg_unroll1": [(SEG_FILE, "constexpr int UNROLL = 4;",
                     "constexpr int UNROLL = 1;")],
}
# the sorted path's C interface (seg_reduce.cu up to commit 98f36eb)
SORTED_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


def make_sources(name: str, base: Path, edits) -> Path:
    """A copy of the sources in ``base`` (those of FILES it holds) under
    build/ab/<name>/src with ``edits`` applied."""
    dst = AB_DIR / name / "src"
    dst.mkdir(parents=True, exist_ok=True)
    for f in FILES:
        if (base / f).exists():
            shutil.copyfile(base / f, dst / f)
    for f, old, new in edits:
        text = (dst / f).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"ablation {name}: {old!r} occurs "
                                 f"{text.count(old)} times in {f}")
        (dst / f).write_text(text.replace(old, new))
    return dst


def kernels_of(src: Path, edits=None) -> list:
    """The kernels a build compiles: those whose sources it holds, or, for
    an ablation, those its edits touch (the walks share pair_power.cuh)."""
    if edits is None:
        have = {f for f in FILES if (src / f).exists()}
    else:
        have = {f for f, _, _ in edits}
    out = []
    if have & set(WALK_FILES):
        out += ["fwd", "bwd"]
    if SEG_FILE in have:
        out.append("seg")
    return out


def build_libs(srcs: dict) -> dict:
    """Compiles every build's kernels ({name: (dir, kernels)}), one nvcc
    each, all at once -> {name: {"fwd"/"bwd"/"seg": CDLL, "ptxas": [lines],
    "sorted": bool}}."""
    procs = []
    for name, (src, kinds) in srcs.items():
        for k in kinds:
            lib = AB_DIR / name / f"lib{k}.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                   str(src / KERNELS[k])]
            procs.append((name, k, lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    out = {name: {"ptxas": []} for name in srcs}
    failed = []
    for name, k, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}/{k}: nvcc exit {proc.returncode}\n{log}")
            continue
        out[name]["ptxas"] += [f"{k}: {line.strip()}"
                               for line in log.splitlines()
                               if "registers" in line or "spill" in line]
        cdll = ctypes.CDLL(str(lib))
        if k == "fwd":
            cdll.fwd_pairwalk_launch.argtypes = hopper_raster._LAUNCH_ARGTYPES
            cdll.fwd_pairwalk_launch.restype = ctypes.c_int
        elif k == "bwd":
            cdll.bwd_pairwalk_launch.argtypes = hopper_raster._BWD_ARGTYPES
            cdll.bwd_pairwalk_launch.restype = ctypes.c_int
        else:
            out[name]["sorted"] = not hasattr(cdll, "seg_reduce_scratch_ints")
            if out[name]["sorted"]:
                cdll.seg_reduce_launch.argtypes = SORTED_ARGTYPES
                cdll.seg_reduce_launch.restype = ctypes.c_int
            else:
                hopper_raster.seg_lib(cdll)
        out[name][k] = cdll
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return out


def run_fwd(lib, args, C: int, cfg: RasterConfig):
    gpair, starts, counts, origins = args
    T, P = starts.shape[0], cfg.tile_size ** 2
    out = torch.empty((T, C + 4, P), dtype=torch.float32, device=gpair.device)
    err = lib.fwd_pairwalk_launch(
        gpair.data_ptr(), gpair.shape[1], starts.data_ptr(),
        counts.data_ptr(), origins.data_ptr(), out.data_ptr(), T, C,
        cfg.tile_size, cfg.alpha_max, cfg.alpha_min, cfg.transmittance_eps,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"fwd_pairwalk_launch: CUDA error {err}")
    return out


def run_bwd(lib, args, C: int, cfg: RasterConfig, dtype):
    gpair, starts, counts, origins, jhi, fwd_out, cot = args
    rows, PC = gpair.shape
    slab = torch.empty((PC, rows), dtype=dtype, device=gpair.device)
    err = lib.bwd_pairwalk_launch(
        gpair.data_ptr(), PC, starts.data_ptr(), counts.data_ptr(),
        origins.data_ptr(), jhi.data_ptr(), fwd_out.data_ptr(),
        cot.data_ptr(), slab.data_ptr(), starts.shape[0], rows, C,
        cfg.tile_size, int(dtype == torch.bfloat16), cfg.alpha_max,
        cfg.alpha_min, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bwd_pairwalk_launch: CUDA error {err}")
    return slab


def run_seg(lib: dict, seg_args):
    """One build's whole reduction, from pair_idx to [K, rows]."""
    slab, pair_idx, prc = seg_args
    if not lib["sorted"]:
        return hopper_raster.seg_reduce_launch(lib["seg"], slab, pair_idx,
                                               prc)
    si, perm = torch.sort(pair_idx, stable=True)
    ends = torch.cumsum(prc, 0, dtype=torch.int32)
    perm, si = perm.to(torch.int32), si.to(torch.int32)
    PC, rows = slab.shape
    K = prc.shape[0]
    out = torch.empty((K, rows), dtype=torch.float32, device=slab.device)
    err = lib["seg"].seg_reduce_launch(
        slab.data_ptr(), int(slab.dtype == torch.bfloat16), rows, PC,
        perm.data_ptr(), si.data_ptr(), ends.data_ptr(), K, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"seg_reduce_launch: CUDA error {err}")
    return out


def split_inputs(walk_args, bargs):
    """The walks' inputs cut to the tenth of the tiles with the most pairs
    ("long") and to the rest ("short"): the other tiles get no pairs (and
    jhi -1), so the kernel reads and writes only the kept tiles."""
    gpair, starts, counts, origins = walk_args
    T = counts.numel()
    long = torch.zeros(T, dtype=torch.bool, device=counts.device)
    long[torch.argsort(counts, descending=True)[:max(1, T // 10)]] = True
    out = {}
    for name, keep in (("long", long), ("short", ~long)):
        c = torch.where(keep, counts, torch.zeros_like(counts))
        j = torch.where(keep, bargs[4], torch.full_like(bargs[4], -1))
        out[name] = ((gpair, starts, c, origins),
                     (gpair, starts, c, origins, j, bargs[5], bargs[6]),
                     int(c.sum()))
    return out


def bwd_rel_l2(got, ref, mask, C: int) -> float:
    g, r = got[mask].float(), ref[mask].float()
    return max(cs.rel_l2(g[:, i], r[:, i])
               for i in range(hopper_raster.N_FIXED + C))


def ab_walks(libs: dict, walk_args, C: int, cfg, seed: int, reps: int):
    """The walks' checks and times (module docstring) -> ({build:
    results}, ok, the backward's inputs)."""
    fwd_new = run_fwd(libs["new"]["fwd"], walk_args, C, cfg)
    bargs = cs.bwd_inputs(walk_args, fwd_new, C, seed)
    PC = walk_args[0].shape[1]
    mask = cs.segment_mask(walk_args[1], walk_args[2], PC)
    plain = {dt: hopper_raster.bwd_pairwalk_plain(*bargs, C, cfg, dt)
             for dt in (torch.bfloat16, torch.float32)}
    names = [n for n, lib in libs.items() if "fwd" in lib]
    res, ok = {}, True
    for name in names:
        lib = libs[name]
        fwd = run_fwd(lib["fwd"], walk_args, C, cfg)
        r = {"fwd_bitwise_equal_new": bool(torch.equal(fwd, fwd_new))}
        for dt, limit in cs.BWD_TOL.items():
            a = run_bwd(lib["bwd"], bargs, C, cfg, dt)
            b = run_bwd(lib["bwd"], bargs, C, cfg, dt)
            key = str(dt)[6:]
            r[f"bwd_{key}_rel_l2"] = bwd_rel_l2(a, plain[dt], mask, C)
            r[f"bwd_{key}_repeat_bitwise"] = bool(torch.equal(a[mask],
                                                              b[mask]))
            ok &= r[f"bwd_{key}_rel_l2"] <= limit
            ok &= r[f"bwd_{key}_repeat_bitwise"]
        ok &= r["fwd_bitwise_equal_new"]
        r["fwd_ms"], r["bwd_ms"] = [], []
        res[name] = r
    torch.cuda.synchronize()

    dt = hopper_raster.GRAD_SLAB_DTYPE
    for name in names + list(reversed(names)):
        lib = libs[name]
        res[name]["fwd_ms"].append(cs.event_ms(
            lambda: run_fwd(lib["fwd"], walk_args, C, cfg), reps))
        res[name]["bwd_ms"].append(cs.event_ms(
            lambda: run_bwd(lib["bwd"], bargs, C, cfg, dt), reps))
    new = libs["new"]
    res["new"]["fwd_ms_host_paced"] = cs.event_ms(
        lambda: run_fwd(new["fwd"], walk_args, C, cfg), reps,
        host_ahead=False)
    res["new"]["bwd_ms_host_paced"] = cs.event_ms(
        lambda: run_bwd(new["bwd"], bargs, C, cfg, dt), reps,
        host_ahead=False)
    # where the time goes: the longest tiles alone against the rest
    split = {}
    for part, (fa, ba, n_pairs) in split_inputs(walk_args, bargs).items():
        split[part] = {
            "pairs": n_pairs,
            "fwd_ms": cs.event_ms(lambda: run_fwd(new["fwd"], fa, C, cfg),
                                  reps),
            "bwd_ms": cs.event_ms(lambda: run_bwd(new["bwd"], ba, C, cfg,
                                                  dt), reps)}
    res["new"]["split"] = split
    for r in res.values():
        r["fwd_ms_mean"] = sum(r["fwd_ms"]) / len(r["fwd_ms"])
        r["bwd_ms_mean"] = sum(r["bwd_ms"]) / len(r["bwd_ms"])
    return res, ok, bargs


def poisoned_tail(slab, walk_args):
    """The slab with every row outside the tiles' segments (rows the walk
    never writes) set to NaN."""
    mask = cs.segment_mask(walk_args[1], walk_args[2], slab.shape[0])
    out = slab.clone()
    out[~mask] = float("nan")
    return out


def trained_view(seed: int, dev):
    """The train path's reduction inputs: chip_smoke.py phase 9's trainer
    (6 keyframes of the room x map(10), then 20 refinement iterations), its
    last keyframe's view under its final caps, the bf16 slab of a seeded
    cotangent -> (walk inputs, C, pr, raster config, kmax)."""
    room = cs.make_room_scene(cs.N_GAUSSIANS, seed, dev)
    cfg = cs.replica_config()
    frames = cs.make_keyframes(room, cfg, cs.N_KEYFRAMES, dev)
    trainer = MappingTrainer(cfg, capacity=cs.TRAIN_CAPACITY, seed=seed,
                             device=dev)
    for f in frames:
        trainer.add_keyframe(*f)
        trainer.map(cs.MAP_ITERS)
    trainer.color_refinement(cs.REFINE_ITERS)
    walk_args, C, pr, rcfg = cs.train_view(trainer, frames[-1])
    return walk_args, C, pr, rcfg, pairs.big_tiles_for(rcfg, cfg.width,
                                                       cfg.height)


def long_run_view(n: int, like, seed: int):
    """Reduction inputs of ``like``'s sizes (K ranks, PC positions, slab
    rows and dtype), made from ``seed`` on its device: rank 0 emits ``n``
    pairs, every other rank 0-3, in a random order among filler ids K ->
    (slab, pair_idx, per_rank_counts), kmax."""
    slab, _, prc = like
    PC, rows = slab.shape
    K, dev = prc.numel(), slab.device
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    counts = torch.randint(0, 4, (K,), generator=g, device=dev,
                           dtype=torch.int32)
    counts[0] = n
    ids = torch.repeat_interleave(
        torch.arange(K, device=dev, dtype=torch.int32), counts)
    if ids.numel() > PC:
        raise ValueError(f"{ids.numel()} pairs do not fit {PC} positions")
    ids = torch.cat([ids, torch.full((PC - ids.numel(),), K,
                                     dtype=torch.int32, device=dev)])
    ids = ids[torch.randperm(PC, generator=g, device=dev)]
    x = torch.randn((PC, rows), generator=g, device=dev).to(slab.dtype)
    return (x, ids, counts), n


def ab_seg(libs: dict, seg_args, kmax: int, card: str, view: str,
           reps: int):
    """The reduction's checks and times on one view (module docstring) ->
    ({build: results}, ok, the package path's chip_smoke timing)."""
    names = [n for n, lib in libs.items() if "seg" in lib]
    ref = hopper_raster.seg_reduce_plain(*seg_args, kmax)
    res, ok = {}, True
    for name in names:
        a = run_seg(libs[name], seg_args)
        b = run_seg(libs[name], seg_args)
        r = {"sorted_path": libs[name]["sorted"],
             "rel_l2": cs.rel_l2(a, ref),
             "finite": bool(torch.isfinite(a).all()),
             "zero_rows_equal": bool(torch.equal(a == 0, ref == 0)),
             "repeat_bitwise": bool(torch.equal(a, b)), "ms": []}
        ok &= (r["rel_l2"] <= cs.SEG_TOL and r["finite"]
               and r["zero_rows_equal"] and r["repeat_bitwise"])
        res[name] = r
    for name in names + list(reversed(names)):
        lib = libs[name]
        res[name]["ms"].append(cs.event_ms(lambda: run_seg(lib, seg_args),
                                           reps))
    for name, r in res.items():
        r["ms_mean"] = sum(r["ms"]) / len(r["ms"])
        # each launch's device time (torch.profiler)
        prof = cs.profile(lambda: run_seg(libs[name], seg_args),
                          r["ms_mean"], reps)
        r["kernels_ms"] = {row["name"][:60]: row["ms"]
                           for row in prof["top"]}
    package = cs.time_seg(seg_args, kmax, card, view)
    slab, pair_idx, prc = seg_args
    package.update(K=int(prc.numel()), PC=int(slab.shape[0]),
                   emitted_pairs=int(prc.sum()),
                   surviving_pairs=int((pair_idx < prc.numel()).sum()),
                   kmax=kmax)
    return res, ok, package


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", action="append", default=[],
                    help="NAME=DIR: another build's source directory")
    ap.add_argument("--ablations", action="store_true",
                    help="add every build of ABLATIONS")
    ap.add_argument("--ablation", action="append", default=[],
                    choices=sorted(ABLATIONS), help="add this one")
    ap.add_argument("--train", action="store_true",
                    help="also A/B the reduction on the train path's view")
    ap.add_argument("--long-run", type=int, default=0, metavar="N",
                    help="also A/B the reduction on a synthetic input with "
                         "a run of N pairs")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    dev = torch.device("cuda", 0)

    srcs = {"new": (make_sources("new", build.CSRC, []), list(KERNELS))}
    for spec in args.ref:
        name, d = spec.split("=", 1)
        src = make_sources(name, REPO / d, [])
        srcs[name] = (src, kernels_of(src))
    for name in ABLATIONS if args.ablations else args.ablation:
        srcs[name] = (make_sources(name, build.CSRC, ABLATIONS[name]),
                      kernels_of(None, ABLATIONS[name]))
    libs = build_libs(srcs)

    scene = cs.make_scene(cs.N_GAUSSIANS, args.seed, dev)
    cams = cs.make_cameras(cs.WIDTH, cs.HEIGHT, args.seed, dev)
    cfg = cs.size_pair_array(scene, cams, RasterConfig(use_pallas=True))
    walk_args, C, pr = cs.walk_inputs(scene, cams[0], cfg)
    walks, ok, bargs = ab_walks(libs, walk_args, C, cfg, args.seed,
                                args.reps)

    new = libs["new"]
    slab = run_bwd(new["bwd"], bargs, C, cfg, torch.bfloat16)
    views = {"serve view 0": (
        (poisoned_tail(slab, walk_args), pr["pair_idx"],
         pr["per_rank_counts"]),
        pairs.big_tiles_for(cfg, cs.WIDTH, cs.HEIGHT))}
    if args.train:
        twalk, tC, tpr, tcfg, tkmax = trained_view(args.seed, dev)
        with torch.no_grad():
            tout = run_fwd(new["fwd"], twalk, tC, tcfg)
            tslab = run_bwd(new["bwd"], cs.bwd_inputs(twalk, tout, tC,
                                                      args.seed),
                            tC, tcfg, torch.bfloat16)
        views["train view"] = (
            (poisoned_tail(tslab, twalk), tpr["pair_idx"],
             tpr["per_rank_counts"]),
            tkmax)
    if args.long_run:
        views[f"long run {args.long_run}"] = long_run_view(
            args.long_run, views["serve view 0"][0], args.seed)
    segs, package = {}, {}
    for view, (seg_args, kmax) in views.items():
        r, v_ok, package[view] = ab_seg(libs, seg_args, kmax, card, view,
                                        args.reps)
        ok &= v_ok
        for name, x in r.items():
            segs.setdefault(name, {})[view] = x

    for name, lib in libs.items():
        line = {"build": name, "ptxas": lib["ptxas"]}
        if name in walks:
            line["walks"] = walks[name]
        if name in segs:
            line["seg_reduce"] = segs[name]
        print(json.dumps(line), flush=True)
    print(card)
    base = walks["new"]
    print(json.dumps({
        "ok": bool(ok), "card": card,
        "slab": str(hopper_raster.GRAD_SLAB_DTYPE)[6:], "reps": args.reps,
        "timing": "host-ahead (chip_smoke.event_ms)",
        "fwd_ms": {n: r["fwd_ms_mean"] for n, r in walks.items()},
        "bwd_ms": {n: r["bwd_ms_mean"] for n, r in walks.items()},
        "host_paced_ms": {"fwd": base["fwd_ms_host_paced"],
                          "bwd": base["bwd_ms_host_paced"]},
        "seg_ms": {n: {v: x["ms_mean"] for v, x in r.items()}
                   for n, r in segs.items()},
        "seg_package": package,
        "new_over": {n: {"fwd": base["fwd_ms_mean"] / r["fwd_ms_mean"],
                         "bwd": base["bwd_ms_mean"] / r["bwd_ms_mean"]}
                     for n, r in walks.items()},
        "seg_new_over": {n: {v: segs["new"][v]["ms_mean"] / x["ms_mean"]
                             for v, x in r.items()}
                         for n, r in segs.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
