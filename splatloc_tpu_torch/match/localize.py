"""Visual localization service: the reference LocalizeQuery
(test.py:86-566).

Port of ``splatloc_tpu.match.localize``. Per query: retrieval (a
precomputed table) -> SuperPoint query features (precomputed or the live
extractor) -> frustum gather of key Gaussians in the retrieved db view +
KD-snap to db keypoints -> descriptor field decode -> Hungarian matching ->
PnP+RANSAC -> optional render-loss 6-DoF pose refinement through the
rasterizer's pose gradients.

Refinement picks the raster path by device, as the JAX package picks it by
backend (localize.py:323): the pair kernels on the card, the tiled blend on
the CPU, unless the caller passes a ``RasterConfig``. The JAX package's one
compiled ``lax.while_loop`` per pyramid level becomes a Python loop here,
and each iteration reads its stop test on the host: ``refine_pose`` counts
every host sync it makes (``info["syncs"]``).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from splatloc_tpu_torch.core import transforms
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.fields import FeatureFieldConfig, decode
from splatloc_tpu_torch.match import frustum, hungarian, pnp
from splatloc_tpu_torch.raster import render
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.utils.profiling import span


def load_retrieval_table(path: str) -> dict:
    """netvlad_retrieval.txt: one line per query, 'query db1 db2 ...'
    (reference test.py:167-177)."""
    table = {}
    with open(path) as f:
        for line in f:
            tok = line.strip().split()
            if not tok:
                continue
            q = os.path.basename(tok[0]).split(".")[0]
            table[q] = [os.path.basename(t).split(".")[0] for t in tok[1:]]
    return table


class PrecomputedQueryFeatures:
    """Query SuperPoint features from files: {dir}/{name}.npz with
    keypoints [N,2] (u,v) and descriptors [256,N]."""

    def __init__(self, directory: str):
        self.directory = directory

    def __call__(self, name: str) -> dict:
        z = np.load(os.path.join(self.directory, f"{name}.npz"))
        return {"keypoints": z["keypoints"], "descriptors": z["descriptors"]}


class LiveQueryFeatures:
    """Query SuperPoint features extracted on the fly (the reference
    extracts live via hloc, test.py:208-227)."""

    def __init__(self, sp_weights_path: str, dataset,
                 max_keypoints: int = 4096, device="cuda"):
        from splatloc_tpu_torch.match import superpoint
        self.params = superpoint.load_params(sp_weights_path, device)
        self.dataset = dataset
        self.max_keypoints = max_keypoints
        self.device = device

    def __call__(self, name: str) -> dict:
        from splatloc_tpu_torch.match import superpoint
        idx = self.dataset.name_to_index(name)
        rgb = self.dataset.load_image(idx)
        gray = torch.as_tensor(
            (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
             + 0.114 * rgb[..., 2]).astype(np.float32), device=self.device)
        out = superpoint.extract(self.params, gray,
                                 max_keypoints=self.max_keypoints)
        valid = out["valid"].cpu().numpy()
        return {"keypoints": out["keypoints"].cpu().numpy()[valid],
                "descriptors": out["descriptors"].cpu().numpy()[:, valid]}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


_STAGE_SPANS = {n: f"localize.{n}"
                for n in ("frustum", "decode", "match", "pnp", "refine")}


class _Stage:
    """One stage of a query: times its block to the device's end of its
    work into the Localizer's ``last_stages[name]``; with tracing on, the
    block is also the span ``localize.<name>``."""
    __slots__ = ("loc", "name", "span", "t0")

    def __init__(self, loc: "Localizer", name: str):
        self.loc = loc
        self.name = name

    def __enter__(self):
        self.span = span(_STAGE_SPANS[self.name])
        self.span.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, kind, *exc):
        if kind is None:
            _sync(self.loc.device)
            self.loc.last_stages[self.name] = time.perf_counter() - self.t0
        return self.span.__exit__(kind, *exc)


class Localizer:
    def __init__(self, scene, decoder_params, field_cfg: FeatureFieldConfig,
                 train_dataset, retrieval_table: dict,
                 query_features, eval_K: np.ndarray,
                 marker_thresh: float = 0.005, sim_thresh: float = 0.4,
                 subset_xyz: np.ndarray | None = None,
                 refine_with_render_loss: bool = False,
                 inlier_px: float = 12.0,
                 save_match_dir: str | None = None,
                 raster_cfg: RasterConfig | None = None, device="cuda"):
        self.scene = scene
        self.decoder_params = decoder_params
        self.field_cfg = field_cfg
        self.train_dataset = train_dataset
        self.retrieval_table = retrieval_table
        self.query_features = query_features
        self.eval_K = eval_K
        self.marker_thresh = marker_thresh
        self.sim_thresh = sim_thresh
        self.subset_xyz = subset_xyz
        self.refine_with_render_loss = refine_with_render_loss
        self.inlier_px = inlier_px
        self.save_match_dir = save_match_dir
        self.raster_cfg = raster_cfg
        self.device = device
        # host copies of the map
        alive = scene.alive.cpu().numpy()
        self.xyz = scene.xyz.detach().cpu().numpy()[alive]
        self.marker = scene.marker.detach().cpu().numpy()[alive, 0]
        # synchronised wall seconds of each stage of the last query
        self.last_stages: dict = {}

    def _stage(self, name: str) -> "_Stage":
        return _Stage(self, name)

    # -- db-side 3D keypoints + descriptors ----------------------------

    def get_frustum_points(self, db_frame: dict):
        """Reference get_frusm_pts (test.py:247-285). The descriptors
        [P, 256] stay on the device for the matching."""
        ds = self.train_dataset
        with self._stage("frustum"):
            if self.subset_xyz is not None:
                pts3d, pts2d = frustum.frustum_key_points(
                    self.subset_xyz, None, db_frame["w2c"], ds.K,
                    ds.width, ds.height, subset=True, device=self.device)
            else:
                pts3d, pts2d = frustum.frustum_key_points(
                    self.xyz, self.marker, db_frame["w2c"], ds.K,
                    ds.width, ds.height,
                    db_mask=np.asarray(db_frame["sp_kp_mask"]) == 1,
                    db_depth=np.asarray(db_frame["depth"]),
                    c2w=db_frame["c2w"], marker_thresh=self.marker_thresh,
                    device=self.device)
        if pts3d.shape[0] == 0:
            return pts3d, torch.zeros((0, self.field_cfg.final_dim),
                                      device=self.device), pts2d
        with self._stage("decode"):
            feats = decode(self.decoder_params,
                           torch.as_tensor(np.asarray(pts3d, np.float32),
                                           device=self.device),
                           self.field_cfg)
        return pts3d, feats, pts2d

    # -- per-query ------------------------------------------------------

    def localize(self, query_frame: dict, query_name: str):
        """Returns (retrieval_result, match_result) dicts like the reference
        localize_image/match_feature (test.py:304-419). ``last_stages``
        then holds the synchronised wall seconds of each stage the query
        reached, and of the whole query ("total")."""
        self.last_stages = {}
        t_start = time.perf_counter()
        try:
            with span("localize.query", query=query_name):
                return self._localize(query_frame, query_name)
        finally:
            self.last_stages["total"] = time.perf_counter() - t_start

    def _localize(self, query_frame: dict, query_name: str):
        t_start = time.perf_counter()
        with span("localize.retrieval"):
            names = self.retrieval_table[query_name]
            db_index = self.train_dataset.name_to_index(names[0])
            db_frame = self.train_dataset.get_frame(db_index)

            retrieval_ret = {"r": db_frame["c2w"][:3, :3],
                             "t": db_frame["c2w"][:3, 3]}
        self.last_stages["retrieval"] = time.perf_counter() - t_start

        db_kps_3d, db_feats_3d, db_kps_2d = self.get_frustum_points(db_frame)
        if db_kps_3d.shape[0] < 5:
            return retrieval_ret, {**retrieval_ret, "success": False}

        with self._stage("match"):
            qf = self.query_features(query_name)
            matches, sims = hungarian.hungarian_solve(
                qf["descriptors"], db_feats_3d.T, sim_thresh=self.sim_thresh,
                device=self.device)
            q2d = qf["keypoints"][matches[0]]
            p3d = db_kps_3d[matches[1]]

        with self._stage("pnp"):
            ret = pnp.solve_pnp_ransac(q2d.astype(np.float32),
                                       p3d.astype(np.float32), self.eval_K,
                                       inlier_px=self.inlier_px,
                                       device=self.device)
        if self.save_match_dir is not None:
            # per-query 2D-3D match dump for visualization/debug
            # (reference test.py:358-368)
            match_info = {"success": bool(ret["success"]),
                          "2d": q2d, "3d": p3d}
            if ret["success"]:
                match_info["inliers"] = ret["inliers"]
            os.makedirs(self.save_match_dir, exist_ok=True)
            np.save(os.path.join(self.save_match_dir, f"{query_name}.npy"),
                    match_info)
        if not ret["success"]:
            return retrieval_ret, {**retrieval_ret, "success": False}
        match_ret = {"r": ret["r"], "t": ret["t"], "success": True,
                     "num_inliers": ret["num_inliers"]}

        if self.refine_with_render_loss and "rgb" in query_frame:
            match_ret = {**match_ret, "pnp_r": match_ret["r"],
                         "pnp_t": match_ret["t"]}
            with self._stage("refine"):
                match_ret = self.render_refine(match_ret, query_frame)
        return retrieval_ret, match_ret

    # -- render-loss 6-DoF refinement -----------------------------------

    def render_refine(self, match_ret: dict, query_frame: dict,
                      iters: int = 64, lr: float = 2e-3,
                      rtol: float = 1e-4):
        """Polish the PnP pose by Adam descent of the photometric render
        loss through the rasterizer's pose gradients (``refine_pose``)."""
        ds = self.train_dataset
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, :3] = match_ret["r"]
        c2w[:3, 3] = match_ret["t"]
        w2c0 = torch.as_tensor(np.linalg.inv(c2w), device=self.device)
        cam0 = Camera.create(np.eye(4, dtype=np.float32), ds.fx, ds.fy,
                             ds.cx, ds.cy, ds.width, ds.height,
                             device=self.device)
        gt = torch.as_tensor(np.asarray(query_frame["rgb"], np.float32),
                             device=self.device)
        xi, info = refine_pose(self.scene, cam0, w2c0, gt, iters=iters,
                               lr=lr, rtol=rtol, raster_cfg=self.raster_cfg)
        w2c = (transforms.se3_exp(xi) @ w2c0).cpu().numpy()
        c2w = np.linalg.inv(w2c)
        return {**match_ret, "r": c2w[:3, :3], "t": c2w[:3, 3],
                "refined": True, "refine_iters": int(info["iters"]),
                "refine_seed_evals": int(info.get("seed_evals", 0)),
                "refine_loss": (float(info["loss0"]), float(info["loss"])),
                "refine_info": info}


def _l1(scene, camera: Camera, w2c, gt, cfg: RasterConfig):
    out = render(scene, camera.replace_pose(w2c), cfg)
    return torch.mean(torch.abs(out["render"] - gt))


def _pose_loss(scene, camera: Camera, w2c, gt,
               cfg: RasterConfig) -> torch.Tensor:
    """Render loss of one pose (the JAX package's ``_pose_loss_jit``)."""
    with torch.no_grad():
        return _l1(scene, camera, w2c, gt, cfg)


def _seed_losses(scene, camera: Camera, xis, w2c0, gt,
                 cfg: RasterConfig) -> torch.Tensor:
    """Render loss of every seed pose ``xis`` [S,6] (se3 perturbations of
    ``w2c0``) -> [S] on the device (``_seed_losses_jit``)."""
    with torch.no_grad():
        return torch.stack([_l1(scene, camera, transforms.se3_exp(xi) @ w2c0,
                                gt, cfg) for xi in xis])


def _refine_level(scene, camera: Camera, w2c0, gt, iters: int, lr: float,
                  rtol: float, patience: int, cfg: RasterConfig):
    """One pyramid level (``_refine_pose_jit``): Adam on the se3 update of
    ``w2c0`` with best-so-far tracking, stopping after ``patience``
    iterations in a row without a ``rtol`` relative improvement or at
    ``iters``. Returns (best xi [6], {"iters", "loss0", "loss",
    "syncs"}): the stop test is read on the host once per iteration."""
    dev = w2c0.device
    b1, b2, eps = 0.9, 0.999, 1e-8
    f32 = dict(dtype=torch.float32, device=dev)
    # constants are filled on the device: torch.tensor(x, device=...)
    # copies from the host and waits for the stream
    z = torch.zeros(6, **f32)
    xi, m, v, bxi = z, z, z, z
    loss0 = torch.full((), float("inf"), **f32)
    # best starts LARGE-FINITE, not inf: inf - rtol*inf is nan and would
    # make the improvement test unconditionally false
    best = torch.full((), 1e30, **f32)
    stall = torch.zeros((), **f32)
    b1t, b2t = torch.full((), b1, **f32), torch.full((), b2, **f32)
    i, syncs = 0, 0
    while i < iters:
        syncs += 1
        if not float(stall) < patience:
            break
        xr = xi.detach().requires_grad_(True)
        loss = _l1(scene, camera, transforms.se3_exp(xr) @ w2c0, gt, cfg)
        (g,) = torch.autograd.grad(loss, xr)
        loss = loss.detach()
        if i == 0:
            loss0 = loss
        better = loss < best - rtol * torch.abs(best)
        stall = torch.where(better, 0.0, stall + 1.0)
        bxi = torch.where(better, xi, bxi)
        best = torch.where(better, loss, best)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1t ** (i + 1.0))
        vh = v / (1 - b2t ** (i + 1.0))
        xi = xi - lr * mh / (torch.sqrt(vh) + eps)
        i += 1
    return bxi, {"iters": float(i), "loss0": loss0, "loss": best,
                 "syncs": syncs}


def _level_cam_gt(camera: Camera, gt, s: int):
    """Camera + target at downscale factor s (pixel-center-correct principal
    point: centers sit at half-integers, so c' = (c + 0.5)/s - 0.5 — plain
    c/s biases the coarse objective by ~0.4 px at s=4)."""
    if s == 1:
        return camera, gt
    H, W = camera.height, camera.width
    cam_s = Camera.create(camera.w2c, camera.fx / s, camera.fy / s,
                          (camera.cx + 0.5) / s - 0.5,
                          (camera.cy + 0.5) / s - 0.5, W // s,
                          H // s, camera.znear, camera.zfar,
                          device=camera.device)
    gt_s = gt.reshape(H // s, s, W // s, s, gt.shape[-1]).mean((1, 3))
    return cam_s, gt_s


def refine_pose(scene, camera: Camera, w2c0, gt, iters: int = 64,
                lr: float = 2e-3, rtol: float = 1e-4, patience: int = 8,
                levels: tuple[int, ...] = (8, 4, 2, 1),
                multi_start_deg: tuple[float, ...] = (7.0, 14.0),
                raster_cfg: RasterConfig | None = None):
    """Render-loss 6-DoF pose refinement: returns (xi [6] se3 update in the
    w2c frame, info dict with iters/loss0/loss/seed_evals, the per-level
    records ``levels`` and the host syncs ``syncs``: one read per iteration
    (the stop test, and the one that stops a level on patience), one for
    the seed losses, one for every level's losses together and one for the
    guard, and one upload for each of ``gt`` and ``w2c0`` passed as a host
    array or on another device).

    Coarse-to-fine: each entry of ``levels`` is a downscale factor — the
    scene is re-rendered at camera/s resolution against an s x s
    average-pooled target, widening the photometric convergence basin. Per
    level, Adam with best-so-far tracking stops after ``patience``
    consecutive iterations without a ``rtol`` relative improvement.

    ``multi_start_deg`` widens the rotational basin: before the pyramid,
    pure camera-frame pitch/yaw perturbations of the start pose (±deg about
    the camera x/y axes) are scored by render loss at the coarsest level,
    and the pyramid starts from the best seed (the identity seed is always
    included). A full-resolution acceptance guard keeps the start pose when
    the refined one scores worse. ``raster_cfg`` None renders through the
    pair kernels on the card and the tiled blend on the CPU."""
    dev = camera.device
    cfg = raster_cfg if raster_cfg is not None else RasterConfig.for_device(
        dev)
    # a host array's upload waits for the stream: counted as a sync
    syncs = sum(not (torch.is_tensor(x) and x.device == dev)
                for x in (gt, w2c0))
    gt = torch.as_tensor(gt, dtype=torch.float32, device=dev)
    w2c0 = torch.as_tensor(w2c0, dtype=torch.float32, device=dev)
    w2c = w2c0
    H, W = camera.height, camera.width
    total_iters, loss0 = 0.0, None
    records = []
    lvls = [s for s in levels if s == 1 or
            (W % s == 0 and H % s == 0 and min(W, H) // s >= 16)]
    degs = [d for d in multi_start_deg if d > 0]
    seed_evals = 0
    if degs and lvls:
        cam_c, gt_c = _level_cam_gt(camera, gt, lvls[0])
        # 8 compass directions in the (x, y) plane per angle, made on the
        # device (in float64, as numpy would) so no upload waits
        f64 = dict(dtype=torch.float64, device=dev)
        a = (torch.arange(8, **f64) * (np.pi / 4.0)).repeat(len(degs))
        th = torch.cat([torch.full((8,), float(np.radians(d)), **f64)
                        for d in degs])
        seeds_t = torch.zeros((1 + 8 * len(degs), 6), dtype=torch.float32,
                              device=dev)
        seeds_t[1:, 3] = (th * torch.cos(a)).float()
        seeds_t[1:, 4] = (th * torch.sin(a)).float()
        losses = _seed_losses(scene, cam_c, seeds_t, w2c0, gt_c,
                              cfg).cpu().numpy()
        syncs += 1
        best = int(np.argmin(losses))
        if best != 0:
            w2c = transforms.se3_exp(seeds_t[best]) @ w2c0
        seed_evals = seeds_t.shape[0]
    level_losses = []
    for s in lvls:
        cam_s, gt_s = _level_cam_gt(camera, gt, s)
        xi, info = _refine_level(scene, cam_s, w2c, gt_s, iters, lr, rtol,
                                 patience, cfg)
        w2c = transforms.se3_exp(xi) @ w2c
        total_iters += info["iters"]
        syncs += info["syncs"]
        records.append({"scale": s, "iters": int(info["iters"])})
        level_losses.append(torch.stack([info["loss0"], info["loss"]]))
        if loss0 is None:
            loss0 = info["loss0"]
    if level_losses:
        # every level's (loss0, loss) in one host read
        for rec, (l0, l1) in zip(records, torch.stack(
                level_losses).cpu().tolist()):
            rec.update(loss0=l0, loss=l1)
        syncs += 1
    # full-resolution acceptance guard: coarse levels optimize a slightly
    # different objective (downscale render vs pooled target) and can drift
    # when the start pose is already near-perfect — refinement must never
    # return a pose that scores worse than the start at full resolution
    l_ref = _pose_loss(scene, camera, w2c, gt, cfg)
    l_start = _pose_loss(scene, camera, w2c0, gt, cfg)
    start_ref = torch.stack([l_start, l_ref]).cpu()
    syncs += 1
    common = {"iters": total_iters, "seed_evals": seed_evals,
              "levels": records, "syncs": syncs}
    if start_ref[0] <= start_ref[1]:
        return torch.zeros(6, device=dev), {**common, "loss0": l_start,
                                            "loss": l_start,
                                            "guard_kept_start": True}
    xi_total = transforms.se3_log(w2c @ transforms.invert_se3(w2c0))
    return xi_total, {**common, "loss0": loss0, "loss": l_ref,
                      "guard_kept_start": False}
