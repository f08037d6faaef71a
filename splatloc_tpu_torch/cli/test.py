"""Evaluation entry point (reference test.py): --eval_pose, --eval_rendering,
--eval_selection [--landmark_num N], on one CUDA device.

Port of ``splatloc_tpu.cli.test``. Renders pick the raster path by device,
as the JAX package picks it by backend: the pair kernels on the card, the
tiled blend on the CPU.

Usage: python -m splatloc_tpu_torch.cli.test --config <yaml> --eval_pose ...
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from splatloc_tpu_torch.cli.config import load_config, save_dir_for
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.dist import multihost
from splatloc_tpu_torch.eval import metrics, selection
from splatloc_tpu_torch.fields import FeatureFieldConfig
from splatloc_tpu_torch.match.localize import (Localizer,
                                               PrecomputedQueryFeatures,
                                               load_retrieval_table)
from splatloc_tpu_torch.raster import render
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene import ply
from splatloc_tpu_torch.train.decoder_train import load_params
from splatloc_tpu_torch.train.losses import ssim


class EvalSession:
    """Holds map + decoder + datasets (reference LocalizeQuery.pre_setting,
    test.py:87-151), on ``device``."""

    def __init__(self, config: dict, save_dir: str,
                 refine_with_render_loss: bool = False, device="cuda"):
        from splatloc_tpu_torch.data import load_dataset
        self.config = config
        self.save_dir = save_dir
        self.device = device
        self.train_dataset = load_dataset(config, train=True)
        self.test_dataset = load_dataset(config, train=False)

        ply_path = os.path.join(save_dir, "point_cloud", "final",
                                "point_cloud.ply")
        sh_degree = 3 if config["Training"].get("spherical_harmonics") else 0
        self.scene = ply.load_scene(ply_path, sh_degree=sh_degree,
                                    device=device)

        self.field_cfg = FeatureFieldConfig.from_config(config)
        ckpt = os.path.join(save_dir, "train_feat", "ckpt.npz")
        self.decoder_params = (load_params(ckpt, device)
                               if os.path.exists(ckpt) else None)

        table_path = os.path.join(self.train_dataset.generated_folder,
                                  "netvlad_retrieval.txt")
        self.retrieval_table = (load_retrieval_table(table_path)
                                if os.path.exists(table_path) else {})
        qf_dir = os.path.join(self.train_dataset.generated_folder,
                              "query_features")
        sp_weights = config.get("Eval", {}).get("superpoint_weights")
        if os.path.isdir(qf_dir):
            self.query_features = PrecomputedQueryFeatures(qf_dir)
        elif sp_weights and os.path.exists(sp_weights):
            from splatloc_tpu_torch.match.localize import LiveQueryFeatures
            self.query_features = LiveQueryFeatures(
                sp_weights, self.test_dataset, device=device)
        else:
            self.query_features = PrecomputedQueryFeatures(qf_dir)
        # The reference hardcodes per-dataset eval intrinsics
        # (test.py:48-62); those values equal the dataset calibration, which
        # is used directly so non-standard resolutions also work.
        self.eval_K = self.train_dataset.K.astype(np.float64)
        self.refine = refine_with_render_loss
        # reference hardcodes ransac_thresh=12 px at fx~320-572 (test.py:64);
        # configurable for other focal lengths
        self.inlier_px = config.get("Eval", {}).get("pnp_inlier_px", 12.0)
        self.raster_cfg = RasterConfig.for_device(device)

    def make_localizer(self, subset_xyz=None,
                       save_match: bool = False) -> Localizer:
        match_dir = (os.path.join(self.save_dir, "save_match")
                     if save_match else None)
        return Localizer(self.scene, self.decoder_params, self.field_cfg,
                         self.train_dataset, self.retrieval_table,
                         self.query_features, self.eval_K,
                         subset_xyz=subset_xyz,
                         refine_with_render_loss=self.refine,
                         inlier_px=self.inlier_px,
                         save_match_dir=match_dir,
                         raster_cfg=self.raster_cfg, device=self.device)

    # -- eval_pose (test.py:463-517) -----------------------------------

    def eval_pose(self, file_name: str = "eval_pose.txt",
                  subset_xyz=None, max_queries: int | None = None,
                  save_pose: bool = False, save_match: bool = False,
                  on_query=None):
        """Protocol: every valid query with a retrieval entry is counted in
        BOTH medians. On match failure (<5 candidates or PnP failure) the
        match pose falls back to the retrieval pose (reference
        test.py:318-326) and the query stays in the population; solved and
        failed counts are reported so the numbers are comparable.
        ``on_query(name, localizer, retrieval_ret, match_ret, frame)``, if
        given, is called after each query (per-query instrumentation)."""
        loc = self.make_localizer(subset_xyz, save_match=save_match)
        r_t, r_r, m_t, m_r = [], [], [], []
        n_solved = n_failed = 0
        poses = {"retrieval_r": [], "retrieval_t": [], "match_r": [],
                 "match_t": [], "gt": []}
        n = len(self.test_dataset)
        if max_queries:
            n = min(n, max_queries)
        for i in range(n):
            qf = self.test_dataset.get_frame(i)
            if not qf["valid"]:
                continue
            name = self.test_dataset.index_to_name(i)
            if name not in loc.retrieval_table:
                continue
            retrieval_ret, match_ret = loc.localize(qf, name)
            if on_query is not None:
                on_query(name, loc, retrieval_ret, match_ret, qf)
            if match_ret["success"]:
                n_solved += 1
            else:
                n_failed += 1
            rr, rt = metrics.pose_errors(retrieval_ret["r"],
                                         retrieval_ret["t"], qf["c2w"])
            mr, mt = metrics.pose_errors(match_ret["r"], match_ret["t"],
                                         qf["c2w"])
            r_r.append(rr)
            r_t.append(rt)
            m_r.append(mr)
            m_t.append(mt)
            if save_pose:
                poses["retrieval_r"].append(retrieval_ret["r"])
                poses["retrieval_t"].append(retrieval_ret["t"])
                poses["match_r"].append(match_ret["r"])
                poses["match_t"].append(match_ret["t"])
                poses["gt"].append(qf["c2w"])
        print(f"eval_pose over {len(m_t)} queries "
              f"({n_solved} solved, {n_failed} retrieval-fallback)")
        if m_t:
            print(f"  Retrieval median: {np.median(r_t)*100:.2f} cm "
                  f"{np.median(r_r):.3f} deg")
            print(f"  Match     median: {np.median(m_t)*100:.2f} cm "
                  f"{np.median(m_r):.3f} deg")
            if multihost.is_primary():
                metrics.write_pose_report(
                    os.path.join(self.save_dir, file_name), r_t, r_r, m_t,
                    m_r, n_solved=n_solved, n_failed=n_failed)
        if save_pose and m_t:
            # reference save_poses/save_errors npy dumps (test.py:437-461)
            d = os.path.join(self.save_dir, "save_pose")
            os.makedirs(d, exist_ok=True)
            for k, v in poses.items():
                np.save(os.path.join(d, f"{k}.npy"), np.stack(v))
            np.save(os.path.join(d, "retrieval_errors.npy"),
                    np.stack([r_t, r_r]))
            np.save(os.path.join(d, "match_errors.npy"),
                    np.stack([m_t, m_r]))
        return m_t, m_r

    # -- eval_rendering (test.py:519-551) ------------------------------

    def eval_rendering(self, max_frames: int | None = None):
        ds = self.test_dataset
        cam0 = Camera.create(np.eye(4, dtype=np.float32), ds.fx, ds.fy,
                             ds.cx, ds.cy, ds.width, ds.height,
                             device=self.device)
        lp_path = os.environ.get(
            "SPLATLOC_LPIPS_WEIGHTS",
            os.path.join(os.path.dirname(__file__), "..", "..", "weights",
                         "lpips_alex.npz"))
        lp_params = metrics.load_lpips_params(lp_path, self.device)
        if lp_params is None:
            # fail loudly, not with NaN rows in eval_rendering.txt: without
            # converted weights the LPIPS column is omitted with a marker
            import warnings
            warnings.warn("no converted LPIPS weights (weights/"
                          "lpips_alex.npz) — eval_rendering.txt will mark "
                          "mean_lpips UNAVAILABLE (tools/convert_lpips.py)")
        lp = metrics.lpips_fn(lp_params)

        psnrs, ssims, lpipss = [], [], []
        n = len(ds) if max_frames is None else min(len(ds), max_frames)
        for i in range(n):
            f = ds.get_frame(i)
            if not f["valid"]:
                continue
            gt = torch.as_tensor(np.asarray(f["rgb"], np.float32),
                                 device=self.device)
            with torch.no_grad():
                out = render(self.scene, cam0.replace_pose(
                    torch.as_tensor(f["w2c"])), self.raster_cfg)
                img = torch.clamp(out["render"], 0.0, 1.0)
                psnrs.append(float(metrics.psnr_masked(img, gt)))
                ssims.append(float(ssim(img, gt)))
                if lp_params is not None:
                    lpipss.append(float(lp(img, gt)))
        out = {"mean_psnr": float(np.mean(psnrs)),
               "mean_ssim": float(np.mean(ssims)),
               "mean_lpips": (float(np.mean(lpipss)) if lpipss else None)}
        if multihost.is_primary():
            metrics.write_rendering_report(
                os.path.join(self.save_dir, "eval_rendering.txt"), **out)
        print(out)
        return out

    # -- eval_selection (test.py:553-566) ------------------------------

    def eval_selection(self, landmark_num: int = 5000,
                       max_queries: int | None = None):
        marker = self.scene.marker.cpu().numpy()[:, 0]
        alive = self.scene.alive.cpu().numpy()
        key_pts = self.scene.xyz.cpu().numpy()[alive & (marker > 0.005)]
        poses, valid = self.train_dataset.load_all_poses()
        w2cs = np.linalg.inv(poses[valid])
        depths = self.train_dataset.load_all_depth()
        subset = selection.select_landmarks(
            key_pts, w2cs, self.train_dataset.K, depths, landmark_num,
            device=self.device)
        return self.eval_pose(
            file_name=f"eval_selection_{landmark_num}.txt",
            subset_xyz=subset.astype(np.float32), max_queries=max_queries)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--eval_pose", action="store_true")
    parser.add_argument("--eval_rendering", action="store_true")
    parser.add_argument("--eval_selection", action="store_true")
    parser.add_argument("--landmark_num", type=int, default=5000)
    parser.add_argument("--refine_pose", action="store_true",
                        help="render-loss 6-DoF refinement after PnP")
    parser.add_argument("--save_pose", action="store_true",
                        help="dump pose/error npy arrays (test.py:437-461)")
    parser.add_argument("--save_match", action="store_true",
                        help="dump per-query 2D-3D match npy "
                             "(test.py:358-368)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu runs the "
                             "kernels' plain versions)")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    save_dir = save_dir_for(config)
    session = EvalSession(config, save_dir,
                          refine_with_render_loss=args.refine_pose,
                          device=args.device)
    if args.eval_pose:
        session.eval_pose(save_pose=args.save_pose,
                          save_match=args.save_match)
    if args.eval_rendering:
        session.eval_rendering()
    if args.eval_selection:
        session.eval_selection(args.landmark_num)


if __name__ == "__main__":
    main()
