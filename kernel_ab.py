"""A/B of the port's pair-walk kernels against other builds of their
sources, on the same inputs, in one run on one CUDA card.

Each build is a directory holding ``fwd_pairwalk.cu`` and ``bwd_pairwalk.cu``
with the ``pair_power.cuh`` they include. The package's own sources
(``splatloc_tpu_torch/csrc``) are the build named ``new``; ``--ref
NAME=DIR`` adds another, for example an earlier commit's sources taken out
with git into the git-ignored ``build/``:

    mkdir -p build/ab_src/old
    for f in fwd_pairwalk.cu bwd_pairwalk.cu pair_power.cuh; do
      git show <commit>:splatloc_tpu_torch/csrc/$f > build/ab_src/old/$f
    done
    python3 kernel_ab.py --ref old=build/ab_src/old --ablations

``--ablations`` adds builds of the package's sources with one design
choice undone each (ABLATIONS below), made by exact text replacements in a
copy under ``build/ab/``. Every build is compiled with the package's nvcc
flags, loaded with ctypes and launched through the same C functions as the
package's wrappers (``fwd_pairwalk_launch``, ``bwd_pairwalk_launch``,
whose arguments have not changed).

On view 0 of ``chip_smoke.py``'s serve scene (100,000 Gaussians, 640x480,
C = 4) it checks every build's forward output bit for bit against ``new``'s
and its backward slabs (bf16 and f32) against ``bwd_pairwalk_plain`` within
``chip_smoke``'s limits, and two launches of each build's backward for
bitwise equality; then it times every build by CUDA events (the mean of
``--reps`` launches) in the order A B ... B A, so that each build is timed
twice, once early and once late. Prints one JSON line per build, the card's
``nvidia-smi`` line, and a summary line; exits with 1 if a check fails.

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
from splatloc_tpu_torch.raster import RasterConfig, hopper_raster

REPO = Path(__file__).resolve().parent
AB_DIR = REPO / "build" / "ab"
FILES = ("fwd_pairwalk.cu", "bwd_pairwalk.cu", "pair_power.cuh")
# Each ablation undoes one design choice of the package's walks by exact
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
}


def make_sources(name: str, base: Path, edits) -> Path:
    """A copy of the sources in ``base`` under build/ab/<name>/src with
    ``edits`` applied."""
    dst = AB_DIR / name / "src"
    dst.mkdir(parents=True, exist_ok=True)
    for f in FILES:
        shutil.copyfile(base / f, dst / f)
    for f, old, new in edits:
        text = (dst / f).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"ablation {name}: {old!r} occurs "
                                 f"{text.count(old)} times in {f}")
        (dst / f).write_text(text.replace(old, new))
    return dst


def build_libs(srcs: dict) -> dict:
    """Compiles every build's two kernels, one nvcc each, all at once ->
    {name: {"fwd": CDLL, "bwd": CDLL, "ptxas": [lines]}}."""
    procs = []
    for name, src in srcs.items():
        for k in ("fwd_pairwalk", "bwd_pairwalk"):
            lib = AB_DIR / name / f"lib{k}.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                   str(src / f"{k}.cu")]
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
        out[name]["ptxas"] += [line.strip() for line in log.splitlines()
                               if "registers" in line or "spill" in line]
        cdll = ctypes.CDLL(str(lib))
        if k == "fwd_pairwalk":
            cdll.fwd_pairwalk_launch.argtypes = hopper_raster._LAUNCH_ARGTYPES
            cdll.fwd_pairwalk_launch.restype = ctypes.c_int
            out[name]["fwd"] = cdll
        else:
            cdll.bwd_pairwalk_launch.argtypes = hopper_raster._BWD_ARGTYPES
            cdll.bwd_pairwalk_launch.restype = ctypes.c_int
            out[name]["bwd"] = cdll
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ref", action="append", default=[],
                    help="NAME=DIR: another build's source directory")
    ap.add_argument("--ablations", action="store_true",
                    help="add every build of ABLATIONS")
    ap.add_argument("--ablation", action="append", default=[],
                    choices=sorted(ABLATIONS), help="add this one")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    dev = torch.device("cuda", 0)

    srcs = {"new": make_sources("new", build.CSRC, [])}
    for spec in args.ref:
        name, d = spec.split("=", 1)
        srcs[name] = make_sources(name, REPO / d, [])
    for name in ABLATIONS if args.ablations else args.ablation:
        srcs[name] = make_sources(name, build.CSRC, ABLATIONS[name])
    libs = build_libs(srcs)

    scene = cs.make_scene(cs.N_GAUSSIANS, args.seed, dev)
    cams = cs.make_cameras(cs.WIDTH, cs.HEIGHT, args.seed, dev)
    cfg = cs.size_pair_array(scene, cams, RasterConfig(use_pallas=True))
    walk_args, C, _ = cs.walk_inputs(scene, cams[0], cfg)
    fwd_new = run_fwd(libs["new"]["fwd"], walk_args, C, cfg)
    bargs = cs.bwd_inputs(walk_args, fwd_new, C, args.seed)
    PC = walk_args[0].shape[1]
    mask = cs.segment_mask(walk_args[1], walk_args[2], PC)
    plain = {dt: hopper_raster.bwd_pairwalk_plain(*bargs, C, cfg, dt)
             for dt in (torch.bfloat16, torch.float32)}

    res, ok = {}, True
    for name, lib in libs.items():
        fwd = run_fwd(lib["fwd"], walk_args, C, cfg)
        r = {"fwd_bitwise_equal_new": bool(torch.equal(fwd, fwd_new)),
             "ptxas": lib["ptxas"]}
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
    order = list(libs) + list(reversed(libs))
    for name in order:
        lib = libs[name]
        res[name]["fwd_ms"].append(cs.event_ms(
            lambda: run_fwd(lib["fwd"], walk_args, C, cfg), args.reps))
        res[name]["bwd_ms"].append(cs.event_ms(
            lambda: run_bwd(lib["bwd"], bargs, C, cfg, dt), args.reps))
    # where the time goes: the longest tiles alone against the rest
    split = {}
    lib = libs["new"]
    for name, (fa, ba, pairs) in split_inputs(walk_args, bargs).items():
        split[name] = {
            "pairs": pairs,
            "fwd_ms": cs.event_ms(lambda: run_fwd(lib["fwd"], fa, C, cfg),
                                  args.reps),
            "bwd_ms": cs.event_ms(lambda: run_bwd(lib["bwd"], ba, C, cfg,
                                                  dt), args.reps)}
    res["new"]["split"] = split
    base = res["new"]
    for name, r in res.items():
        r["fwd_ms_mean"] = sum(r["fwd_ms"]) / len(r["fwd_ms"])
        r["bwd_ms_mean"] = sum(r["bwd_ms"]) / len(r["bwd_ms"])
        print(json.dumps({"build": name, **r}), flush=True)
    print(card)
    print(json.dumps({"ok": bool(ok), "card": card, "slab": str(dt)[6:],
                      "reps": args.reps,
                      "fwd_ms": {n: r["fwd_ms_mean"] for n, r in res.items()},
                      "bwd_ms": {n: r["bwd_ms_mean"] for n, r in res.items()},
                      "new_over": {n: {"fwd": base["fwd_ms_mean"]
                                       / r["fwd_ms_mean"],
                                       "bwd": base["bwd_ms_mean"]
                                       / r["bwd_ms_mean"]}
                                   for n, r in res.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
