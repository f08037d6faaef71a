"""Reference-scale eval rehearsal of the PyTorch port.

Port of ``tools/eval_rehearsal.py``, step by step: the query path of the
reference (test.py:405-419: retrieval -> SuperPoint -> frustum/KD-snap ->
decoder -> Hungarian -> PnP) and the render-loss refinement, timed per
stage at the scale of a real scene: 640x480 frames, 110,000 alive
Gaussians, 100 database views rendered from the map, 4,096-keypoint
SuperPoint queries, the greedy selection of 5,000 of 30,000 key Gaussians
as landmarks.

The scene and the mask draws come from ``np.random.default_rng(0)`` in the
JAX tool's order, so they are its arrays bit for bit. The decoder and
SuperPoint weights are random (from ``torch.Generator``s seeded 0 and 1,
or passed in), so pose errors mean nothing: the outputs are per-stage wall
times and finite medians. Renders take the device's raster path (the pair
kernels on the card, the tiled blend on the CPU), as the JAX tool takes
the Pallas path off the CPU. Every stage timer stops after the device has
finished its work.

Run:  python -m splatloc_tpu_torch.tools.eval_rehearsal [n_queries]
      [--device cuda|cpu]        (100 queries; cuda unless the CPU is asked
                                  for)
Prints ONE json line with the JAX tool's keys; the rest goes to stderr.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

# the JAX tool's PnP literals: the best matches by similarity fed to RANSAC
# (the batched refine is O(hypotheses x points^2) memory) and its hypotheses
N_KEEP = 512
N_HYPOTHESES = 256


def _orbit_pose(i, n, radius=3.5, height=0.4, target_z=3.5):
    a = 2 * np.pi * i / n
    eye = np.array([radius * np.sin(a), height * np.sin(2 * a),
                    target_z - radius * np.cos(a)], np.float32)
    fwd = np.array([0, 0, target_z], np.float32) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(np.array([0, 1, 0], np.float32), fwd)
    right /= np.linalg.norm(right)
    up = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([right, up, fwd], -1)
    c2w[:3, 3] = eye
    return c2w


class _FakeDataset:
    """In-memory stand-in exposing the dataset surface Localizer uses."""

    def __init__(self, K, width, height, names, frames):
        self.K = K
        self.width, self.height = width, height
        self.fx, self.fy = K[0, 0], K[1, 1]
        self.cx, self.cy = K[0, 2], K[1, 2]
        self._names = {n: i for i, n in enumerate(names)}
        self._frames = frames

    def name_to_index(self, name):
        return self._names[name]

    def get_frame(self, index):
        return self._frames[index]


@dataclasses.dataclass
class RehearsalRun:
    """What ``run`` leaves behind besides the result line: the scene and
    the camera it was rendered through, the database frames (``frames[i]``
    with c2w, w2c, depth, sp_kp_mask and K; ``grays[i]``), the selected
    landmarks, the weights, each refinement (w2c0, gt, xi, info, seconds),
    each PnP call that raised (query index, repr), the per-query stage
    seconds, the wall seconds of the database renders and the selection,
    and, on the card, the peak device memory."""
    result: dict
    scene: object
    cam0: object
    frames: dict
    grays: list
    landmarks: np.ndarray
    decoder_params: dict
    sp_params: dict
    field_cfg: object
    refinements: list
    pnp_errors: list
    stages: dict
    seconds: dict
    peak_mem_gb: float | None


def _synced(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(n_queries: int = 100, device="cuda", W: int = 640, H: int = 480,
        fx: float = 320.0, n_gauss: int = 110_000, capacity: int = 111_232,
        n_train: int = 100, n_key: int = 30_000, n_landmarks: int = 5000,
        mask_px: int = 1500, max_points: int = 4096,
        max_keypoints: int = 4096, n_refine: int = 3, refine_iters: int = 64,
        decoder_params: dict | None = None, sp_params: dict | None = None,
        on_query=None) -> RehearsalRun:
    """The rehearsal; ``main`` prints its result line. The defaults are the
    JAX tool's constants (fx = fy; ``max_points`` its MAXP, the database
    points padded to one shape).
    ``on_query(qi, rec)``, if given, sees each query's record: the query
    features (keypoints, descriptors with invalid slots zeroed, n_valid),
    the padded database points ``pts3d`` and their count ``n_real``, the
    decoded ``feats`` (pad rows zeroed), and where it reached the matching
    (5 points or more) ``matches``, ``sims``, ``keep`` and ``pnp`` (the
    result, or None where it raised)."""
    from splatloc_tpu_torch.core.camera import Camera
    from splatloc_tpu_torch.eval import selection
    from splatloc_tpu_torch.fields.decoder import (FeatureFieldConfig,
                                                   decode, init_decoder)
    from splatloc_tpu_torch.match import frustum, hungarian, pnp, superpoint
    from splatloc_tpu_torch.match.localize import Localizer, refine_pose
    from splatloc_tpu_torch.raster import render
    from splatloc_tpu_torch.raster.types import RasterConfig
    from splatloc_tpu_torch.scene.gaussians import GaussianScene

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("eval_rehearsal: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    N, CAP = n_gauss, capacity
    rng = np.random.default_rng(0)
    K = np.array([[fx, 0, (W - 1) / 2], [0, fx, (H - 1) / 2], [0, 0, 1]])

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def head(base, vals):
        out = base.clone()
        out[:N] = t(vals) if isinstance(vals, np.ndarray) else vals
        return out

    # -- reference-scale scene ----------------------------------------
    xyz = np.stack([rng.uniform(-2.5, 2.5, N), rng.uniform(-1.8, 1.8, N),
                    rng.uniform(1.5, 6.0, N)], -1).astype(np.float32)
    colors = rng.uniform(0.05, 1.0, (N, 3)).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    marker = np.zeros((CAP, 1), np.float32)
    key_idx = rng.choice(N, n_key, replace=False)
    marker[key_idx] = rng.uniform(0.01, 1.0, (n_key, 1))
    scene = GaussianScene.empty(CAP, device=dev)
    if dev.type == "cuda":
        # after the first allocation: on a device named by index, the
        # allocator's stats exist only once the context does
        torch.cuda.reset_peak_memory_stats(dev)
    scene = scene.replace(
        xyz=head(scene.xyz, xyz),
        scaling=head(scene.scaling,
                     rng.uniform(-4.6, -3.2, (N, 3)).astype(np.float32)),
        rotation=head(scene.rotation, quats),
        opacity=head(scene.opacity, 1.5),
        f_dc=head(scene.f_dc,
                  ((colors - 0.5) / 0.28209479177387814)[:, None, :]),
        marker=t(marker),
        alive=head(scene.alive, True))
    log(f"scene: {N} alive / {CAP} capacity")

    cam0 = Camera.create(np.eye(4, dtype=np.float32), K[0, 0], K[1, 1],
                         K[0, 2], K[1, 2], W, H, device=dev)
    rcfg = RasterConfig.for_device(dev)

    def render_at(w2c):
        with torch.no_grad():
            return render(scene, cam0.replace_pose(t(w2c)), rcfg)

    # -- train db frames: poses + rendered depth + kp masks ------------
    _synced(dev)
    t0 = time.perf_counter()
    train_c2w = [_orbit_pose(i, n_train) for i in range(n_train)]
    frames, names = {}, []
    grays = []
    for i, c2w in enumerate(train_c2w):
        w2c = np.linalg.inv(c2w).astype(np.float32)
        out = render_at(w2c)
        depth = out["depth"].cpu().numpy()
        rgbi = out["render"].cpu().numpy()
        mask = np.zeros((H, W), np.uint8)
        ys = rng.integers(0, H, mask_px)
        xs = rng.integers(0, W, mask_px)
        mask[ys, xs] = 1
        name = f"frame{i:06d}"
        names.append(name)
        frames[i] = {"c2w": c2w, "w2c": w2c, "depth": depth,
                     "sp_kp_mask": mask, "K": K}
        grays.append(np.clip(0.299 * rgbi[..., 0] + 0.587 * rgbi[..., 1]
                             + 0.114 * rgbi[..., 2], 0, 1))
    t_db = time.perf_counter() - t0
    log(f"rendered {n_train} db frames (depth + gray) in {t_db:.1f}s")

    # -- landmark selection at reference scale -------------------------
    key_pts = xyz[key_idx]
    w2cs = np.stack([frames[i]["w2c"] for i in range(n_train)])
    depths = np.stack([frames[i]["depth"] for i in range(n_train)])
    t0 = time.perf_counter()
    sel = selection.select_landmarks(key_pts, w2cs, K, depths, n_landmarks,
                                     device=dev)
    t_sel = time.perf_counter() - t0
    log(f"selection: {n_landmarks} of {len(key_pts)} over {n_train} views "
        f"in {t_sel:.1f}s (got {len(sel)})")

    # -- decoder + SuperPoint ------------------------------------------
    fcfg = FeatureFieldConfig(bound=((-2.5, 2.5), (-1.8, 1.8), (1.5, 6.0)),
                              voxel_sdf=0.06)
    if decoder_params is None:
        decoder_params = init_decoder(
            fcfg, torch.Generator(dev).manual_seed(0), device=dev)
    if sp_params is None:
        sp_params = superpoint.init_params(
            torch.Generator(dev).manual_seed(1), device=dev)

    retrieval = {f"q{i:04d}": [names[i % n_train]] for i in range(n_queries)}

    def query_features(name):
        """Fixed-shape query features: invalid keypoint slots keep zero
        descriptors (cosine 0, inert below the 0.4 threshold)."""
        i = int(name[1:]) % n_train
        out = superpoint.extract(sp_params, t(grays[i].astype(np.float32)),
                                 max_keypoints=max_keypoints)
        valid = out["valid"].cpu().numpy()
        desc = out["descriptors"].cpu().numpy()
        desc[:, ~valid] = 0.0
        return {"keypoints": out["keypoints"].cpu().numpy(),
                "descriptors": desc, "n_valid": int(valid.sum())}

    ds = _FakeDataset(K, W, H, names, frames)
    loc = Localizer(scene, decoder_params, fcfg, ds, retrieval,
                    query_features, K, device=dev)

    # -- per-stage timing over queries ---------------------------------
    stage = {k: [] for k in ("superpoint", "frustum_snap", "decode",
                             "hungarian", "pnp", "total")}
    n_solved = 0
    pnp_errors = []
    # warmup (not timed)
    query_features("q0000")
    _synced(dev)
    for qi in range(n_queries):
        qname = f"q{qi:04d}"
        t_q0 = time.perf_counter()
        db_i = ds.name_to_index(retrieval[qname][0])
        db_frame = ds.get_frame(db_i)

        t0 = time.perf_counter()
        qf = query_features(qname)
        _synced(dev)
        stage["superpoint"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        pts3d, pts2d = frustum.frustum_key_points(
            loc.xyz, loc.marker, db_frame["w2c"], K, W, H,
            db_mask=db_frame["sp_kp_mask"] == 1,
            db_depth=db_frame["depth"], c2w=db_frame["c2w"], device=dev)
        _synced(dev)
        stage["frustum_snap"].append(time.perf_counter() - t0)

        # fixed-shape padding of the database points to max_points (pad
        # descriptors are zero: cosine 0, below the 0.4 threshold)
        n_real = min(len(pts3d), max_points)
        pts3d_p = np.zeros((max_points, 3), np.float32)
        pts3d_p[:n_real] = pts3d[:n_real]
        t0 = time.perf_counter()
        feats = decode(decoder_params, t(pts3d_p), fcfg)
        feats[n_real:] = 0.0
        _synced(dev)
        stage["decode"].append(time.perf_counter() - t0)
        pts3d = pts3d_p
        rec = {"qf": qf, "pts3d": pts3d, "n_real": n_real, "feats": feats}

        if n_real >= 5:
            t0 = time.perf_counter()
            matches, sims = hungarian.hungarian_solve(
                qf["descriptors"], feats.T, sim_thresh=0.4, device=dev)
            _synced(dev)
            stage["hungarian"].append(time.perf_counter() - t0)

            # random-weight descriptors leave few sims above the threshold:
            # the N_KEEP best feed RANSAC (the reference's surviving
            # matches are O(100s))
            keep = np.argsort(-sims)[:N_KEEP]
            ret = None
            try:
                t0 = time.perf_counter()
                ret = pnp.solve_pnp_ransac(
                    qf["keypoints"][matches[0][keep]].astype(np.float32),
                    pts3d[matches[1][keep]].astype(np.float32), K,
                    n_hypotheses=N_HYPOTHESES, device=dev)
                _synced(dev)
                stage["pnp"].append(time.perf_counter() - t0)
                n_solved += int(bool(ret["success"]))
            except Exception as e:   # surface, don't kill the rehearsal
                pnp_errors.append((qi, repr(e)))
                log(f"q{qi}: pnp failed: {type(e).__name__}: {e}")
            rec.update(matches=matches, sims=sims, keep=keep, pnp=ret)
        stage["total"].append(time.perf_counter() - t_q0)
        if on_query is not None:
            on_query(qi, rec)
        if qi == 0:
            log(f"q0: {n_real} frustum pts, "
                f"{qf['keypoints'].shape[0]} query kps "
                f"(first query includes first-use costs)")

    # -- render-loss refinement (the added capability), few queries ----
    refinements = []
    for qi in range(n_refine):
        w2c0 = np.linalg.inv(train_c2w[qi]).astype(np.float32)
        gt = render_at(w2c0)["render"]
        w2c0 = t(w2c0)
        _synced(dev)
        t0 = time.perf_counter()
        xi, info = refine_pose(scene, cam0, w2c0, gt, iters=refine_iters)
        _synced(dev)
        refinements.append({"w2c0": w2c0, "gt": gt, "xi": xi, "info": info,
                            "seconds": time.perf_counter() - t0})
    t_ref = [r["seconds"] for r in refinements]
    log(f"render_refine: {[f'{s:.2f}s' for s in t_ref]} "
        "(first includes first-use costs)")

    def med_ms(xs, skip_first=True):
        xs = xs[1:] if (skip_first and len(xs) > 1) else xs
        return round(float(np.median(xs)) * 1e3, 1) if xs else None

    result = {
        "tool": "eval_rehearsal",
        "n_gaussians": N, "image": f"{W}x{H}",
        "n_train_views": n_train, "n_queries": n_queries,
        "db_render_s_total": round(t_db, 1),
        "selection_5000_s": round(t_sel, 1),
        "ms_superpoint": med_ms(stage["superpoint"]),
        "ms_frustum_snap": med_ms(stage["frustum_snap"]),
        "ms_decode": med_ms(stage["decode"]),
        "ms_hungarian": med_ms(stage["hungarian"]),
        "ms_pnp": med_ms(stage["pnp"]),
        "ms_query_total": med_ms(stage["total"]),
        "render_refine_s_steady": (round(float(np.median(t_ref[1:])), 2)
                                   if len(t_ref) > 1 else None),
        "pnp_solved": n_solved,
        "finite": all(np.isfinite(v).all() for v in
                      [np.asarray(stage["total"])]),
    }
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    if peak is not None:
        log(f"peak device memory {peak:.2f} GiB")
    return RehearsalRun(
        result=result, scene=scene, cam0=cam0, frames=frames, grays=grays,
        landmarks=sel, decoder_params=decoder_params, sp_params=sp_params,
        field_cfg=fcfg, refinements=refinements, pnp_errors=pnp_errors,
        stages=stage, seconds={"db_render": t_db, "selection": t_sel,
                               "refine": t_ref},
        peak_mem_gb=peak)


def main(n_queries: int = 100, device="cuda") -> dict:
    res = run(n_queries=n_queries, device=device).result
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_queries", type=int, nargs="?", default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args()
    main(n_queries=args.n_queries, device=args.device)
