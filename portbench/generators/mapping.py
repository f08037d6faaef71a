"""Keyframe mapping on the reference schedule: the generator and window of
every ``generator: mapping`` traffic mix.

Set-up ray-casts the mix's keyframes of a procedural room on the device,
hands them to ``MappingTrainer.add_keyframe``, takes the first
``check_steps`` steps one ``map(1)`` call each (the steps the reference
follows), and warms up through the first densify. The window then runs
``map(chunk)`` calls until ``--seconds`` have passed; no keyframe arrives in
it. After the window the program's state is freed and the plain reference
(``reference/mapping.py``) recomputes the insertion and the first steps.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import time
import warnings

import numpy as np
import torch

from portbench import room as rooms
from portbench.reference import mapping as ref
from portbench.reference.render import Intrinsics


def log(msg: str) -> None:
    print(f"[map] {msg}", file=sys.stderr, flush=True)


def synced(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_frames(cfg: dict, tr: dict, seed: int, device):
    """(room, keyframe w2c [n,4,4], [(rgb, depth, score) float numpy]).
    The room's layout and landmarks come from the mix's ``layout_seed``,
    so every seed maps the same geometry and inserts as many Gaussians;
    the textures come from ``seed``."""
    cal = cfg["Dataset"]["Calibration"]
    bound = cfg["scene"]["bound"]
    layout = tr["layout_seed"]
    bare = rooms.make_room(bound, layout, 0, np.zeros((0, 3)))
    poses = rooms.keyframe_poses(bare, tr["keyframes"])
    centres = np.stack([np.linalg.inv(p)[:3, 3] for p in poses])
    room = rooms.make_room(bound, layout, tr["furniture"], centres, seed)
    gen = torch.Generator(device=device).manual_seed(layout)
    marks, _ = rooms.surface_points(room, tr["landmarks"], gen, device)
    frames = []
    for w2c in poses:
        rgb, depth, _ = rooms.raycast(room, w2c, cal["fx"], cal["fy"],
                                      cal["cx"], cal["cy"], cal["width"],
                                      cal["height"], device)
        score = rooms.score_map(marks, w2c, depth, cal["fx"], cal["fy"],
                                cal["cx"], cal["cy"])
        frames.append(tuple(x.cpu().numpy() for x in (rgb, depth, score)))
    return room, poses, frames


@contextlib.contextmanager
def counted_syncs():
    """Count the host syncs of the block on the card (the warnings of
    torch.cuda.set_sync_debug_mode, as the port's
    ``utils.profiling.count_syncs`` counts them): yields a list that holds
    the count once the block has closed."""
    out = []
    with warnings.catch_warnings(record=True):
        # the first switch of the mode in a process warns once by itself
        torch.cuda.set_sync_debug_mode("warn")
        torch.cuda.set_sync_debug_mode(0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(0)
    out.append(sum("synchroniz" in str(x.message) for x in w))


def prepare(cell, seed: int, dev) -> dict:
    """Set-up up to the first steps: the keyframes made and added, and the
    ``check_steps`` steps the reference follows, each one ``map(1)`` call
    (the window's own call). Returns what the comparison and the window
    need."""
    from splatloc_tpu_torch.train.mapping import MappingConfig, MappingTrainer

    cfg, tr = cell.config, cell.traffic
    cal = cfg["Dataset"]["Calibration"]
    K = Intrinsics(cal["fx"], cal["fy"], cal["cx"], cal["cy"], cal["width"],
                   cal["height"])
    mcfg = MappingConfig.from_config(cfg)
    t0 = time.perf_counter()
    room, poses, frames = make_frames(cfg, tr, seed, dev)
    log(f"set-up: {len(frames)} keyframes ray-cast "
        f"({len(room.furn_lo)} furniture boxes) in "
        f"{time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    trainer = MappingTrainer(mcfg, capacity=cfg["tpu"]["capacity"],
                             frame_capacity=len(frames), seed=seed,
                             device=dev)
    alive_after = [0]
    for (rgb, depth, score), w2c in zip(frames, poses):
        trainer.add_keyframe(rgb, depth, score, w2c)
        alive_after.append(int(trainer.scene.num_alive))
    state0 = {k: getattr(trainer.scene, k).clone() for k in ref.FIELDS}
    alive0 = trainer.scene.alive.clone()
    synced(dev)
    log(f"set-up: keyframes added, {alive_after[-1]} Gaussians alive of "
        f"{trainer.scene.capacity}, in {time.perf_counter() - t0:.2f} s")
    losses, grad_m = [], None
    for _ in range(tr["check_steps"]):
        losses.append(trainer.map(1))
        if grad_m is None:
            grad_m = {k: trainer.opt_state.m[k].clone() for k in ref.FIELDS}
    state_n = {k: getattr(trainer.scene, k).clone() for k in ref.FIELDS}
    return {"trainer": trainer, "cfg": cfg, "mcfg": mcfg, "K": K,
            "frames": frames, "poses": poses, "state0": state0,
            "alive0": alive0, "alive_after": alive_after, "grad_m": grad_m,
            "state_n": state_n, "losses": losses, "seed": seed}


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    tr = cell.traffic
    dev = torch.device(device)
    pre = prepare(cell, seed, dev)
    trainer, mcfg, K = pre["trainer"], pre["mcfg"], pre["K"]
    t0 = time.perf_counter()
    while trainer.iteration < tr["warmup_iters"]:
        trainer.map(min(tr["chunk_iters"],
                        tr["warmup_iters"] - trainer.iteration))
    synced(dev)
    log(f"set-up: warm-up to iteration {trainer.iteration} in "
        f"{time.perf_counter() - t0:.2f} s, "
        f"{int(trainer.scene.num_alive)} alive")
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------
    cycle = mcfg.gaussian_update_every
    it0 = trainer.iteration
    with counted_syncs() if trace else contextlib.nullcontext() as syncs:
        t_w = time.perf_counter()
        while time.perf_counter() - t_w < seconds:
            tc = time.perf_counter()
            trainer.map(tr["chunk_iters"])
            log(f"chunk to iteration {trainer.iteration}: "
                f"{(time.perf_counter() - tc) * 1e3 / tr['chunk_iters']:.3f}"
                " ms a step")
        synced(dev)
        wall = time.perf_counter() - t_w
    steps = trainer.iteration - it0
    log(f"window: {steps} steps in {wall:.3f} s, "
        f"{int(trainer.scene.num_alive)} alive, "
        f"{trainer.n_dropped_total} pairs dropped so far")
    ctx = {"wall_per_step_s": wall / steps, "steps": steps,
           "image": (K.width, K.height), "channels": 4,
           "tile": mcfg.tile_size}
    if syncs:
        ctx["host_syncs"] = syncs[0]

    if trace:
        from portbench import profile
        chunk = tr["chunk_iters"]

        def has_densify(it):
            return any(i % cycle == mcfg.gaussian_update_offset
                       or i % mcfg.gaussian_reset == 0
                       for i in range(it + 1, it + chunk + 1))
        while has_densify(trainer.iteration):
            trainer.map(chunk)
        with profile.traced(dev) as tp:
            trainer.map(chunk)
        ctx["trace"] = tp
        ctx["traced_steps"] = chunk
        scene_t = {k: getattr(trainer.scene, k).clone()
                   for k in ref.FIELDS}
        alive_t = trainer.scene.alive.clone()

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del trainer
    pre.pop("trainer")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference ------------------------------------------------
    t0 = time.perf_counter()
    values = compare(pre, dev)
    log(f"reference: {time.perf_counter() - t0:.2f} s")

    if trace:
        ctx["work"] = walk_work(scene_t, alive_t, pre["poses"], K, dev)
        ctx["counts_per_step"] = step_flops(ctx["work"], scene_t, alive_t,
                                            K, mcfg.window_size)
    return {"setup_s": setup_s,
            "end_to_end": {"map_step_ms": wall / steps * 1e3},
            "ctx": ctx, "values": values, "attempted": steps, "failed": 0,
            "memory_peak_bytes": peak}


def windows(seed: int, n_frames: int, size: int, steps: int) -> list:
    """The keyframes of each of the first steps: the trainer's draws
    (numpy's default_rng(seed), one permutation a step)."""
    rng = np.random.default_rng(seed)
    return [rng.permutation(n_frames)[:size] for _ in range(steps)]


def reference_steps(pre: dict, dev, dtype=torch.float32,
                    half_window: bool = False) -> dict:
    """The plain reference's first steps from the program's state after
    insertion (``reference.mapping.run_steps``), on the trainer's windows;
    ``half_window`` plants a fault: each window's first half only, its
    sum scaled to the whole window."""
    mcfg, frames, poses = pre["mcfg"], pre["frames"], pre["poses"]
    thresh = mcfg.rgb_boundary_threshold
    qframes = []
    for (rgb, depth, score), w2c in zip(frames, poses):
        q = ref.quantise_frame(rgb, depth, score, thresh)
        qframes.append(tuple(torch.as_tensor(x, device=dev) for x in q)
                       + (torch.as_tensor(w2c, device=dev),))
    wins = windows(pre["seed"], len(frames), mcfg.window_size,
                   len(pre["losses"]))
    scale = 1.0
    if half_window:
        keep = max(len(wins[0]) // 2, 1)
        scale = len(wins[0]) / keep
        wins = [w[:keep] for w in wins]
    rows = torch.nonzero(pre["alive0"])[:, 0]
    st = {k: v[rows] for k, v in pre["state0"].items()}
    alive = torch.ones(rows.shape[0], dtype=torch.bool, device=dev)
    return ref.run_steps(st, alive, qframes, wins, pre["K"],
                         pre["cfg"]["opt_params"], thresh, dtype, scale)


def insert_gaps(pre: dict, dev, round_bf16: bool = False) -> dict:
    """Each insertion gap, the largest over the keyframes (``round_bf16``:
    the program's inserted values rounded to bfloat16, the control)."""
    mcfg = pre["mcfg"]
    thresh = mcfg.rgb_boundary_threshold
    rows = torch.nonzero(pre["alive0"])[:, 0]
    out, aa = {}, pre["alive_after"]
    for i, ((rgb, depth, score), w2c) in enumerate(zip(pre["frames"],
                                                       pre["poses"])):
        valid = rgb.astype(np.float32).sum(-1) > thresh
        fl = (torch.as_tensor(rgb, device=dev),
              torch.as_tensor(np.where(valid, depth, 0.0).astype(np.float32),
                              device=dev),
              torch.as_tensor(score, device=dev))
        sl = rows[aa[i]:aa[i + 1]]
        added = {k: pre["state0"][k][sl] for k in ("xyz", "f_dc", "scaling")}
        if round_bf16:
            added = {k: v.to(torch.bfloat16).float()
                     for k, v in added.items()}
        for k, v in ref.insertion_gaps(
                added, fl, torch.as_tensor(w2c, device=dev), pre["K"],
                mcfg.point_size, mcfg.pcd_downsample, thresh).items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def gaps(losses, grad1, change, r: dict) -> dict:
    """``loss_gap`` (each step's loss, relative), ``grad_gap`` and
    ``change_gap`` (by the worst leaf) of one side against the
    reference's steps ``r``."""
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-12)
                            for a, b in zip(losses, r["loss"])),
            "grad_gap": leaf_gap(grad1, r["grad1"], r["grad1"]),
            "change_gap": leaf_gap(change, r["change"], r["grad1"])}


def compare(pre: dict, dev) -> dict:
    """The compared numbers: ``insert_gaps`` (the inserted Gaussians against
    their pixels), and the program's first steps against the reference's
    (``gaps``)."""
    r = reference_steps(pre, dev)
    rows = torch.nonzero(pre["alive0"])[:, 0]
    g = {k: pre["grad_m"][k][rows] / (1 - ref.B1) for k in ref.FIELDS}
    d = {k: pre["state_n"][k][rows] - pre["state0"][k][rows]
         for k in ref.FIELDS}
    log(f"losses: program {pre['losses']}, reference {r['loss']}")
    return {**insert_gaps(pre, dev),
            **gaps(pre["losses"], g, d, r)}


def leaf_gap(prog: dict, refv: dict, ref_grad: dict) -> float:
    """max over leaves of | |prog| - |ref| | / max(|ref|, median leaf's
    |ref|), leaving out leaves whose reference gradient is under a
    thousandth of the median leaf's."""
    gn = {k: float(torch.linalg.norm(v.double())) for k, v in
          ref_grad.items()}
    gmed = float(np.median(list(gn.values())))
    keep = [k for k in refv if gn[k] >= 1e-3 * gmed]
    rn = {k: float(torch.linalg.norm(refv[k].double())) for k in keep}
    med = float(np.median(list(rn.values())))
    return max(abs(float(torch.linalg.norm(prog[k].double())) - rn[k])
               / max(rn[k], med, 1e-30) for k in keep)


def walk_work(scene: dict, alive, poses, K: Intrinsics, dev) -> dict:
    """The pair walks' work on the traced scene, averaged over the
    keyframe views (a step renders a random window of them)."""
    tot = {}
    with torch.no_grad():
        for w2c in poses:
            *_, work = ref.render(scene["xyz"], scene["scaling"],
                                  scene["rotation"], scene["opacity"],
                                  scene["f_dc"], scene["kp_score"], alive,
                                  torch.as_tensor(w2c, device=dev), K,
                                  counts=True)
            for k, v in work.items():
                tot[k] = tot.get(k, 0.0) + v
    return {k: v / len(poses) for k, v in tot.items()}


# float32 operations, counted from the shapes
OPS_PROJECT = 120           # per visible Gaussian and view: EWA, conic, rect
OPS_ADAM = 12               # per parameter value
PARAMS_PER_GAUSSIAN = 16    # xyz 3, f_dc 3, scaling 3, rotation 4, o, m, kp
OPS_LOSS_PIXEL = 40         # per pixel and view: L1 colour, depth, BCE, grads


def step_flops(work: dict, scene: dict, alive, K: Intrinsics,
               views: int) -> float:
    """The float32 operations one mapping step needs: both walks' and the
    reduction's (as the rooflines count them), projection forward and
    backward per visible Gaussian, the loss per pixel, Adam per live
    parameter value."""
    from portbench import peaks
    C = 4
    walks = (work["evals_fwd"] * peaks.OPS_PER_EVAL
             + work["evals_bwd"] * peaks.OPS_PER_EVAL
             + work["blended"] * peaks.ops_per_blend(C)
             + work["pairs"] * (peaks.N_FIXED + C))
    per_view = walks + 2 * OPS_PROJECT * work["visible"] + (
        OPS_LOSS_PIXEL * K.width * K.height)
    n_alive = float(alive.sum())
    return views * per_view + OPS_ADAM * PARAMS_PER_GAUSSIAN * n_alive
