"""Closed-loop query stream at reference scale, one client: the generator
and window of every ``generator: localize`` traffic mix.

Set-up makes, from the seed, a map of Gaussians on a procedural room's
surfaces (some of them key Gaussians), ray-cast database depth maps,
``eval.selection.select_landmarks``'s landmarks, random decoder weights,
and one query per database pose a few cm and degrees off it. A query's
key points are every selected landmark it sees (its projection with about
a pixel of noise, its descriptor the plain decoder's feature turned away by
a drawn angle) and outliers at random pixels with random unit descriptors,
up to the mix's key point count. Retrieval answers the nearest database
pose. The window calls ``Localizer.localize`` (landmark subset, no
refinement) on the queries in a fixed order, cycling. After it, the
plain reference (``reference/localize.py``) recomputes the selection and,
for a sample drawn from the seed of every position the window finished,
the frustum, the decoded features, the assignment and the pose.
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time
import types

import numpy as np
import torch

from portbench import room as rooms
from portbench.reference import localize as ref


def log(msg: str) -> None:
    print(f"[localize] {msg}", file=sys.stderr, flush=True)


def synced(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class Inputs:
    """Everything the benchmark makes and hands to both sides."""
    K: np.ndarray
    W: int
    H: int
    bound: list
    voxel: float
    db: np.ndarray            # [n_db, 4, 4] w2c
    queries: np.ndarray       # [n_q, 4, 4] w2c
    xyz: torch.Tensor         # [N, 3] map Gaussians
    colors: torch.Tensor
    n_key: int
    depths: np.ndarray        # [n_db, H, W]
    table: torch.Tensor
    layers: list
    kps: list                 # per query [n_kp, 2] float32 (numpy)
    desc: torch.Tensor        # [n_q, D, n_kp]
    room: rooms.Room


def decoder_weights(cfg: dict, gen: torch.Generator, device):
    """Random decoder weights: the table uniform in +-1e-4 (tcnn's init),
    each bias-free layer Kaiming-uniform, [in, out], and every layer after
    the first with zero-mean columns. Without that the ReLU layers' common
    positive part points every feature one way (a mean cosine of 0.65
    between landmarks, so most similarities pass the 0.4 cut and the
    auction bids on a dense matrix); with it the mean cosine is ~0.02, as a
    trained field's features differ."""
    hg, dec = cfg["hash_grid"], cfg["decoder"]
    table = (torch.rand((hg["n_levels"], 1 << hg["log2_hashmap_size"],
                         hg["n_features"]), generator=gen, device=device)
             * 2 - 1) * 1e-4
    layers, d_in = [], hg["n_levels"] * hg["n_features"]
    for i in range(dec["num_layers"]):
        d_out = (dec["final_dim"] if i == dec["num_layers"] - 1
                 else dec["hidden_dim"])
        b = 1.0 / np.sqrt(d_in)
        w = (torch.rand((d_in, d_out), generator=gen, device=device)
             * 2 - 1) * b
        layers.append(w if i == 0 else w - w.mean(0, keepdim=True))
        d_in = d_out
    return table, layers


def make_inputs(cfg: dict, tr: dict, seed: int, dev) -> Inputs:
    cal = cfg["Dataset"]["Calibration"]
    W, H = cal["width"], cal["height"]
    fx, fy, cx, cy = cal["fx"], cal["fy"], cal["cx"], cal["cy"]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    bound = cfg["scene"]["bound"]
    layout = tr["layout_seed"]
    bare = rooms.make_room(bound, layout, 0, np.zeros((0, 3)))
    db = rooms.database_poses(bare, tr["database_views"])
    # the query poses follow the layout too, so every seed asks the same
    # frustums; the seed draws the descriptors, noise, weights and order
    rng = np.random.default_rng([layout, 11])
    queries = np.stack([rooms.perturb_pose(db[i % len(db)], rng,
                                           tr["query_offset_m"],
                                           tr["query_offset_deg"])
                        for i in range(tr["queries"])])
    # furniture kept clear of every camera the layout can place, so the
    # room is the same whatever the seed's query offsets
    centres = np.stack([np.linalg.inv(p)[:3, 3] for p in db])
    room = rooms.make_room(bound, layout, tr["furniture"], centres, seed)
    xyz, sid = rooms.surface_points(
        room, tr["gaussians"],
        torch.Generator(device=dev).manual_seed(layout), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    colors = rooms.texture(room, xyz, sid)
    depths = np.stack([rooms.raycast(room, w2c, fx, fy, cx, cy, W, H,
                                     dev)[1].cpu().numpy() for w2c in db])
    table, layers = decoder_weights(cfg, gen, dev)
    return Inputs(K=K, W=W, H=H, bound=bound,
                  voxel=cfg["scene"]["voxel_sdf"], db=db, queries=queries,
                  xyz=xyz, colors=colors, n_key=tr["key_gaussians"],
                  depths=depths, table=table, layers=layers, kps=[],
                  desc=torch.empty(0), room=room)


def make_queries(inp: Inputs, landmarks: np.ndarray, feats: torch.Tensor,
                 tr: dict, seed: int, dev) -> None:
    """Each query's key points and descriptors (``Inputs.kps``/``desc``).

    Inliers: the landmarks in both the retrieved database view's frustum
    and the query's image, each at its projection plus ``pixel_noise`` px,
    its descriptor the feature turned away to a cosine drawn uniformly from
    ``inlier_cos``. Outliers fill up to ``keypoints`` at uniformly random
    pixels, with random unit descriptors."""
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_kp = tr["keypoints"]
    fx, fy, cx, cy = inp.K[0, 0], inp.K[1, 1], inp.K[0, 2], inp.K[1, 2]
    lm = torch.as_tensor(landmarks, device=dev)
    D = feats.shape[1]
    inp.desc = torch.empty((len(inp.queries), D, n_kp), device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lo_c, hi_c = tr["inlier_cos"]
    wh = torch.tensor([inp.W, inp.H], **f32)
    for q, w2c in enumerate(inp.queries):
        rows = torch.as_tensor(np.nonzero(ref.frustum(
            landmarks, inp.db[q % len(inp.db)], inp.K, inp.W, inp.H)[0])[0],
            device=dev)
        uv, z = rooms.project_raw(lm[rows], w2c, fx, fy, cx, cy)
        seen = (z > 0.2) & (uv >= 0).all(-1) & (uv < wh).all(-1)
        cand = torch.nonzero(seen)[:, 0][:n_kp]          # into rows
        f = feats[rows[cand]]
        r = torch.randn(f.shape, generator=gen, **f32)
        r = r - (r * f).sum(-1, keepdim=True) * f
        r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
        c = lo_c + (hi_c - lo_c) * torch.rand((f.shape[0], 1),
                                              generator=gen, **f32)
        d_in = c * f + torch.sqrt(1 - c * c) * r
        uv_in = uv[cand] + torch.randn((cand.shape[0], 2), generator=gen,
                                       **f32) * tr["pixel_noise"]
        uv_in = torch.minimum(uv_in.clamp_min(0), wh - 1e-3)
        n_out = n_kp - cand.shape[0]
        uv_out = torch.rand((n_out, 2), generator=gen, **f32) * wh
        d_out = torch.randn((n_out, D), generator=gen, **f32)
        d_out = d_out / torch.linalg.norm(d_out, dim=-1, keepdim=True)
        perm = torch.randperm(n_kp, generator=gen, device=dev)
        inp.kps.append(torch.cat([uv_in, uv_out])[perm].cpu().numpy())
        inp.desc[q] = torch.cat([d_in, d_out])[perm].T


class _Dataset:
    """The database surface ``Localizer`` reads: intrinsics, names and
    poses."""

    def __init__(self, inp: Inputs):
        self.K = inp.K
        self.width, self.height = inp.W, inp.H
        self.fx, self.fy = inp.K[0, 0], inp.K[1, 1]
        self.cx, self.cy = inp.K[0, 2], inp.K[1, 2]
        self.db = inp.db

    def name_to_index(self, name: str) -> int:
        return int(name[2:])

    def get_frame(self, index: int) -> dict:
        w2c = self.db[index]
        return {"w2c": w2c, "c2w": np.linalg.inv(w2c)}


def make_localizer(inp: Inputs, sel: np.ndarray, cfg: dict, dev,
                   max_rows: int):
    from splatloc_tpu_torch.fields import FeatureFieldConfig
    from splatloc_tpu_torch.match.localize import Localizer
    from splatloc_tpu_torch.scene.gaussians import GaussianScene

    class Recording(Localizer):
        """The Localizer, keeping the first time a query is asked (``keep``
        set to its id) its frustum's points and decoded features (an
        asynchronous copy to host memory)."""
        keep = None

        def get_frustum_points(self, db_frame):
            pts3d, feats, pts2d = super().get_frustum_points(db_frame)
            if self.keep is not None:
                self.kept_feats[self.keep, :feats.shape[0]].copy_(
                    feats, non_blocking=True)
                self.kept_pts[self.keep] = pts3d
            return pts3d, feats, pts2d

    N = inp.xyz.shape[0]
    sc = GaussianScene.empty(N, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    rot = torch.randn((N, 4), generator=g, device=dev)
    marker = torch.zeros((N, 1), device=dev)
    marker[:inp.n_key] = 0.01 + 0.99 * torch.rand((inp.n_key, 1),
                                                   generator=g, device=dev)
    sc = sc.replace(xyz=inp.xyz.clone(),
                    f_dc=((inp.colors - 0.5) / 0.28209479177387814)[:, None],
                    scaling=torch.empty((N, 3), device=dev).uniform_(
                        -4.6, -3.2, generator=g),
                    rotation=rot / torch.linalg.norm(rot, dim=-1,
                                                     keepdim=True),
                    opacity=torch.full((N, 1), 1.5, device=dev),
                    marker=marker, alive=torch.ones(N, dtype=torch.bool,
                                                    device=dev))
    fcfg = FeatureFieldConfig.from_config(cfg)
    names = {f"q{i}": [f"db{i % len(inp.db)}"]
             for i in range(len(inp.queries))}

    def features(name):
        i = int(name[1:])
        return {"keypoints": inp.kps[i], "descriptors": inp.desc[i]}

    loc = Recording(sc, {"table": inp.table, "layers": inp.layers}, fcfg,
                    _Dataset(inp), names, features, inp.K, subset_xyz=sel,
                    refine_with_render_loss=False, device=dev)
    loc.kept_feats = torch.zeros(
        (len(inp.queries), max_rows, cfg["decoder"]["final_dim"]),
        pin_memory=dev.type == "cuda")
    loc.kept_pts = {}
    loc.cur = {}
    tap(loc)
    return loc


def tap(loc) -> None:
    """Route the Localizer's calls of the assignment and of PnP through
    recorders that keep in ``loc.cur`` the matches it made and the 2D-3D
    pairs it handed to PnP (references to the program's arrays, no copy);
    ``loc.untap()`` restores the modules."""
    from splatloc_tpu_torch.match import localize as mod
    hung, pnp = mod.hungarian, mod.pnp

    def solve(*a, **kw):
        out = hung.hungarian_solve(*a, **kw)
        loc.cur["matches"] = out[0]
        return out

    def ransac(pts2d, pts3d, *a, **kw):
        loc.cur["pairs"] = (pts2d, pts3d)
        return pnp.solve_pnp_ransac(pts2d, pts3d, *a, **kw)

    mod.hungarian = types.SimpleNamespace(**{**vars(hung),
                                             "hungarian_solve": solve})
    mod.pnp = types.SimpleNamespace(**{**vars(pnp),
                                       "solve_pnp_ransac": ransac})

    def untap():
        mod.hungarian, mod.pnp = hung, pnp
    loc.untap = untap


def prepare(cell, seed: int, dev) -> dict:
    """Set-up: the inputs, the program's landmark selection, the queries
    and the Localizer."""
    from splatloc_tpu_torch.eval import selection

    cfg, tr = cell.config, cell.traffic
    t0 = time.perf_counter()
    inp = make_inputs(cfg, tr, seed, dev)
    log(f"set-up: map, {len(inp.db)} database depths in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    key = inp.xyz[:inp.n_key].cpu().numpy()
    sel = selection.select_landmarks(key, inp.db, inp.K, inp.depths,
                                     tr["landmarks"], device=dev)
    log(f"set-up: selection of {len(sel)} in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    feats = ref.decode(inp.table, inp.layers,
                       torch.as_tensor(sel, device=dev), inp.bound,
                       inp.voxel)
    make_queries(inp, sel, feats, tr, seed, dev)
    log(f"set-up: {len(inp.queries)} queries of {tr['keypoints']} key "
        f"points in {time.perf_counter() - t0:.2f} s")
    masks = [ref.frustum(sel, w, inp.K, inp.W, inp.H) for w in inp.db]
    sizes = [int(inside.sum()) for inside, _ in masks]
    max_rows = max(int((inside | edge).sum()) for inside, edge in masks)
    order = np.random.default_rng([seed, 19]).permutation(len(inp.queries))
    return {"inp": inp, "sel": sel, "order": order, "sizes": sizes,
            "loc": make_localizer(inp, sel, cfg, dev, max_rows),
            "rec": {}, "seed": seed}


def query(pre: dict, position: int) -> dict:
    """One query of the stream: position ``position`` asks query
    ``order[position % n]`` (the seed's order, cycling). Keeps what the
    query's stages handed on under ``pre["rec"][position]``, and the
    first time a query is asked its frustum's points and features."""
    loc = pre["loc"]
    q = qid(pre, position)
    loc.keep = None if q in loc.kept_pts else q
    loc.cur = {}
    _, match = loc.localize({}, f"q{q}")
    loc.keep = None
    pre["rec"][position] = loc.cur
    return match


def qid(pre: dict, position: int) -> int:
    return int(pre["order"][position % len(pre["order"])])


def sample_positions(pre: dict, n_done: int, k: int) -> list:
    """``k`` of the stream's first ``n_done`` positions, drawn from the
    seed."""
    rng = np.random.default_rng([pre["seed"], 13])
    return sorted(rng.choice(n_done, min(k, n_done),
                             replace=False).tolist())


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    tr = cell.traffic
    dev = torch.device(device)
    pre = prepare(cell, seed, dev)
    loc, sizes = pre["loc"], pre["sizes"]

    # warm-up: the queries with the largest frustums, so the allocator
    # holds the window's largest blocks
    t0 = time.perf_counter()
    warm = np.argsort(sizes)[::-1][:tr["warmup_queries"]]
    for q in warm:
        loc.localize({}, f"q{int(q)}")
    synced(dev)
    log(f"set-up: warm-up of {len(warm)} queries (frustums "
        f"{min(sizes)}-{max(sizes)} landmarks) in "
        f"{time.perf_counter() - t0:.2f} s")
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------
    times, poses, stages = [], [], []
    t_w = time.perf_counter()
    while time.perf_counter() - t_w < seconds:
        t = time.perf_counter()
        poses.append(query(pre, len(poses)))
        times.append(time.perf_counter() - t)
        stages.append(dict(loc.last_stages))
    wall = time.perf_counter() - t_w
    n_fail = sum(not m.get("success", False) for m in poses)
    ms = [t * 1e3 for t in times]
    log(f"window: {len(ms)} queries in {wall:.3f} s, "
        f"{n_fail} without a pose; ms a query: "
        + " ".join(f"{x:.1f}" for x in ms))
    qs = statistics.quantiles(ms, n=10) if len(ms) > 1 else ms * 9
    ctx = {"stages": stages}

    if trace:
        from portbench import profile
        with profile.traced(dev) as tp:
            for q in range(tr["traced_queries"]):
                loc.localize({}, f"q{qid(pre, len(poses) + q)}")
        ctx["trace"] = tp

    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    kept = release(pre, dev)
    t0 = time.perf_counter()
    done = sample_positions(pre, len(poses), tr["sample"])
    values = compare(pre, kept, done, poses, dev)
    log(f"reference: {len(done)} sampled queries in "
        f"{time.perf_counter() - t0:.2f} s")
    return {"setup_s": setup_s,
            "end_to_end": {"query_ms_p50": statistics.median(ms),
                           "query_ms_p90": qs[8]},
            "ctx": ctx, "values": values, "attempted": len(ms),
            "failed": n_fail, "memory_peak_bytes": peak}


def release(pre: dict, dev) -> tuple:
    """Free the Localizer; (kept features on the host, kept points)."""
    loc = pre.pop("loc")
    loc.untap()
    synced(dev)
    kept = (loc.kept_feats.numpy(), loc.kept_pts)
    del loc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return kept


def frustum_ok(mine: np.ndarray, sel: np.ndarray, inside: np.ndarray,
               edge: np.ndarray) -> bool:
    """The program's frustum holds every landmark the reference finds
    inside and none it finds outside, up to those within rounding of the
    edge."""
    row = {tuple(x): i for i, x in enumerate(sel)}
    got = np.zeros(len(sel), bool)
    got[[row[tuple(x)] for x in mine]] = True
    must = inside & ~edge
    may = inside | edge
    return bool((got[must]).all() and not (got & ~may).any())


def compare(pre: dict, kept: tuple, done: list, poses, dev,
            control: bool = False) -> dict:
    """The compared numbers, over the sampled positions ``done``:

    - ``select_gap``: the share of the program's landmarks the reference's
      selection lacks;
    - ``feat_gap``: the largest distance between the program's and the
      reference's unit features of a landmark in the program's frustum (2
      where the frustums differ beyond edge rounding);
    - ``match_miss``: the dominant pairs (``ref.dominant_pairs``) of the
      reference's similarities on which the program's assignment and the
      optimal one differ;
    - ``pose_gap_px``: the largest RMS reprojection gap of a query's
      frustum landmarks between the program's pose and the reference's
      PnP on the 2D-3D pairs the program handed to its PnP, up to pairs
      near the inlier threshold (``ref.pose_gap_near``; inf where only one
      side has a pose).

    ``control`` puts the reference computed one precision step lower in
    the program's place instead."""
    inp, sel, seed = pre["inp"], pre["sel"], pre["seed"]
    kept_feats, kept_pts = kept
    key = inp.xyz[:inp.n_key].cpu().numpy()
    sel_ref = ref.greedy_pick(key, ref.saliency(key, inp.db, inp.K,
                                                inp.depths, dev), len(sel))
    mine_sel = sel
    if control:
        mine_sel = ref.greedy_pick(key, ref.saliency(
            key, inp.db, inp.K, inp.depths, dev, low=True), len(sel))
    select_gap = 1.0 - len({tuple(r) for r in mine_sel}
                           & {tuple(r) for r in sel_ref}) / len(sel)

    def decode(pts, low=False):
        return ref.decode(inp.table, inp.layers,
                          torch.as_tensor(pts, device=dev), inp.bound,
                          inp.voxel, low=low).cpu().numpy()

    feat_gap, miss, pose_gap = 0.0, 0, 0.0
    for p in done:
        q = qid(pre, p)
        db = inp.db[q % len(inp.db)].astype(np.float64)
        inside, edge = ref.frustum(sel, db, inp.K, inp.W, inp.H)
        desc = inp.desc[q].T.cpu().numpy()
        rng = np.random.default_rng([seed, 17, p])
        start = (db[:3, :3], db[:3, 3])
        if control:
            mine = sel[inside]
            fp = decode(mine, low=True)
            r, c = ref.assign(desc, fp, low=True)
            matches, pairs = np.stack([r, c]), (inp.kps[q][r], mine[c])
            mp = ref.pnp(*pairs, inp.K, rng, low=True, start=start)
            rng = np.random.default_rng([seed, 17, p])
        else:
            mine = kept_pts[q]
            fp = kept_feats[q, :len(mine)]
            rec = pre["rec"][p]
            matches, pairs = rec.get("matches"), rec.get("pairs")
            m = poses[p]
            mp = None
            if m.get("success", False):
                Rc = np.asarray(m["r"], np.float64)
                mp = (Rc.T, -Rc.T @ np.asarray(m["t"], np.float64))
        if not frustum_ok(mine, sel, inside, edge):
            feat_gap = 2.0
        f = decode(mine) if len(mine) else fp
        if len(mine):
            feat_gap = max(feat_gap, float(np.linalg.norm(
                fp - f, axis=-1).max()))
        n_dom, n_miss = 0, 0
        if matches is not None:
            n_dom, n_miss = ref.assignment_misses(desc, f, matches)
        miss += n_miss
        rp = (ref.pnp(*pairs, inp.K, rng, start=start)
              if pairs is not None else None)
        if rp is None or mp is None:
            one = (rp is None) != (mp is None)
            if one:
                pose_gap = float("inf")
            log(f"query at {p}: " + ("pose on one side only" if one
                                     else "no pose on either side"))
            continue
        gap = ref.pose_gap_near(mp, rp, *pairs, inp.K, sel[inside])
        n_ref = int((ref.reprojection_px(rp, *pairs, inp.K) < 12.0).sum())
        n_prog = int((ref.reprojection_px(mp, *pairs, inp.K) < 12.0).sum())
        log(f"query at {p}: {len(pairs[0])} pairs, {n_dom} dominant, "
            f"{n_miss} missed; inliers reference {n_ref}, program "
            f"{n_prog}; pose gap {gap:.6f} px")
        pose_gap = max(pose_gap, gap)
    return {"select_gap": select_gap, "feat_gap": feat_gap,
            "match_miss": float(miss), "pose_gap_px": pose_gap}
