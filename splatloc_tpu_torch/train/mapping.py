"""Scene-mapping trainer: port of ``splatloc_tpu.train.mapping`` (the
reference SplatLoc driver, train_gaussians.py:51-355).

Two step functions do the work (a mapping step over a window of keyframes;
a color-refinement step over one keyframe); the host loop samples window
indices, triggers densify / opacity reset on the reference schedule, and
grows the padded capacity when needed. PyTorch runs eagerly, so the steps
are plain functions; a step issues no host sync: its drop counters stay
device tensors until the densify cadence reads them.

Keyframes live on the device in a preallocated FrameStore (rgb uint8, depth
in millimetres, score float16), so a step never copies from the host.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from splatloc_tpu_torch.core import sh as sh_mod
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import rasterize
from splatloc_tpu_torch.raster.types import RasterConfig
from splatloc_tpu_torch.scene import densify, init_rgbd, optim
from splatloc_tpu_torch.scene.gaussians import GaussianScene
from splatloc_tpu_torch.train import losses
from splatloc_tpu_torch.utils.profiling import count, span


class FrameStore:
    """Preallocated on-device keyframe storage. Depth is kept in integer
    millimetres (the reference's uint16 values, held as int32)."""

    def __init__(self, capacity: int, height: int, width: int,
                 device="cuda"):
        self.capacity = capacity
        self.n = 0
        kw = dict(device=device)
        self.rgb = torch.zeros((capacity, height, width, 3),
                               dtype=torch.uint8, **kw)
        self.depth_mm = torch.zeros((capacity, height, width),
                                    dtype=torch.int32, **kw)
        self.score = torch.zeros((capacity, height, width),
                                 dtype=torch.float16, **kw)
        self.w2c = torch.eye(4, dtype=torch.float32, **kw).repeat(
            capacity, 1, 1)
        self.exposure = torch.zeros((capacity, 2), dtype=torch.float32, **kw)

    def append(self, rgb: np.ndarray, depth: np.ndarray, score: np.ndarray,
               w2c: np.ndarray) -> int:
        """rgb [H,W,3] float 0..1 or uint8; depth metric float; score
        [H,W]."""
        i = self.n
        assert i < self.capacity, "FrameStore full"
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        mm = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)
        dev = self.rgb.device
        self.rgb[i] = torch.from_numpy(rgb).to(dev)
        self.depth_mm[i] = torch.from_numpy(mm.astype(np.int32)).to(dev)
        self.score[i] = torch.from_numpy(score.astype(np.float16)).to(dev)
        self.w2c[i] = torch.from_numpy(w2c.astype(np.float32)).to(dev)
        self.n += 1
        return i

    def gather(self, idx) -> dict:
        """The frames at the host indices ``idx``, stacked. Indexing with
        Python ints takes views, so nothing is copied from the host."""
        idx = [int(i) for i in idx]
        return {k: torch.stack([getattr(self, k)[i] for i in idx])
                for k in ("rgb", "depth_mm", "score", "w2c", "exposure")}


@dataclass(frozen=True)
class MappingConfig:
    """Static hyperparameters (reference configs/*/base_config.yaml); the
    same fields and defaults as the JAX package's."""
    width: int = 640
    height: int = 480
    fx: float = 320.0
    fy: float = 320.0
    cx: float = 319.5
    cy: float = 239.5
    window_size: int = 5
    rgb_boundary_threshold: float = 0.01
    primitive_reg: bool = True
    marker_thresh: float = 0.005
    isotropic_weight: float = 0.01
    lambda_dssim: float = 0.2
    sh_degree: int = 0
    # densification (Training + opt_params sections)
    gaussian_update_every: int = 150
    gaussian_update_offset: int = 50
    gaussian_th: float = 0.7
    # cameras_extent * Training.gaussian_extent
    gaussian_extent: float = 6.0
    gaussian_reset: int = 2001
    size_threshold: float = 20.0
    densify_grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    spatial_lr_scale: float = 6.0    # gaussians.init_lr(6.0)
    # adam lrs (opt_params)
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    marker_lr: float = 0.05
    kp_score_lr: float = 0.05
    scaling_lr: float = 0.001
    rotation_lr: float = 0.001
    # rasterizer; use_pallas None = by device (the pair kernels on the
    # card, the tiled blend on the CPU)
    tile_size: int = 16
    max_per_tile: int = 1024
    tile_chunk: int = 32
    use_pallas: bool | None = None
    # pair-binning caps, escalated by the trainer when a step reports
    # dropped pairs: per-Gaussian truncation grows the giant-splat
    # extension (big_k), global-budget overflow grows pair_cap_factor
    max_tiles: int = 6
    pair_cap_factor: int = 3
    # probe-driven static pair budget (RasterConfig.pair_cap_override)
    pair_cap_override: int | None = None
    big_k: int = 256
    big_tiles: int | None = 192
    mid_k: int = 4096
    mid_tiles: int = 48
    # active-set cap (RasterConfig.visible_cap), kept by the trainer at the
    # smallest tier above the alive count + insertion headroom
    visible_cap: int | None = None
    # insertion budgets
    kp_budget: int = 16384
    nonkp_budget: int = 8192
    pcd_downsample: int = 64
    point_size: float = 0.05
    adaptive_pointsize: bool = True

    def raster_config(self, device="cuda") -> RasterConfig:
        """The rasterizer's configuration for a trainer on ``device``."""
        use_pallas = self.use_pallas
        if use_pallas is None:
            use_pallas = RasterConfig.for_device(device).use_pallas
        return RasterConfig(tile_size=self.tile_size,
                            max_per_tile=self.max_per_tile,
                            tile_chunk=self.tile_chunk,
                            use_pallas=use_pallas,
                            max_tiles=self.max_tiles,
                            pair_cap_factor=self.pair_cap_factor,
                            pair_cap_override=self.pair_cap_override,
                            big_k=self.big_k, big_tiles=self.big_tiles,
                            mid_k=self.mid_k, mid_tiles=self.mid_tiles,
                            visible_cap=self.visible_cap)

    def opt_lr_dict(self) -> dict:
        return {k: getattr(self, k) for k in (
            "position_lr_init", "position_lr_final",
            "position_lr_delay_mult", "position_lr_max_steps", "feature_lr",
            "opacity_lr", "marker_lr", "kp_score_lr", "scaling_lr",
            "rotation_lr")}

    @classmethod
    def from_config(cls, config: dict) -> "MappingConfig":
        """Build from a reference-schema YAML config dict."""
        cal = config["Dataset"]["Calibration"]
        tr = config["Training"]
        op = config["opt_params"]
        return cls(
            width=cal["width"], height=cal["height"],
            fx=cal["fx"], fy=cal["fy"], cx=cal["cx"], cy=cal["cy"],
            window_size=tr["window_size"],
            rgb_boundary_threshold=tr["rgb_boundary_threshold"],
            primitive_reg=tr["primitive_reg"],
            gaussian_update_every=tr["gaussian_update_every"],
            gaussian_update_offset=tr["gaussian_update_offset"],
            gaussian_th=tr["gaussian_th"],
            gaussian_extent=6.0 * tr["gaussian_extent"],
            gaussian_reset=tr["gaussian_reset"],
            size_threshold=tr["size_threshold"],
            sh_degree=3 if tr.get("spherical_harmonics") else 0,
            densify_grad_threshold=op["densify_grad_threshold"],
            percent_dense=op["percent_dense"],
            lambda_dssim=op["lambda_dssim"],
            position_lr_init=op["position_lr_init"],
            position_lr_final=op["position_lr_final"],
            position_lr_delay_mult=op["position_lr_delay_mult"],
            position_lr_max_steps=op["position_lr_max_steps"],
            feature_lr=op["feature_lr"],
            opacity_lr=op["opacity_lr"],
            marker_lr=op["marker_lr"],
            kp_score_lr=op["kp_score_lr"],
            scaling_lr=op["scaling_lr"],
            rotation_lr=op["rotation_lr"],
            pcd_downsample=config["Dataset"]["pcd_downsample"],
            point_size=config["Dataset"]["point_size"],
            adaptive_pointsize=config["Dataset"].get("adaptive_pointsize",
                                                     True),
        )


def _base_camera(cfg: MappingConfig, device) -> Camera:
    return Camera.create(np.eye(4, dtype=np.float32), cfg.fx, cfg.fy,
                         cfg.cx, cfg.cy, cfg.width, cfg.height,
                         device=device)


def _render_view(scene: GaussianScene, frame: dict, offset, cfg,
                 base: Camera):
    """Render one keyframe view: SH->RGB conversion + the kp channel.
    ``base`` carries the intrinsics on the scene's device (made once per
    step function: intrinsics copied from the host on every view would
    wait for the stream)."""
    cam = base.replace_pose(frame["w2c"])
    rgb = sh_mod.sh_to_color(cfg.sh_degree, scene.features(), scene.xyz,
                             cam.camera_center)
    colors = torch.cat([rgb, scene.kp_score], dim=-1)
    return rasterize(scene.xyz, scene.scaling_activated(), scene.rotation,
                     scene.opacity_activated(), colors, cam,
                     cfg.raster_config(scene.xyz.device), alive=scene.alive,
                     means2d_offset=offset)


def _camera_cache(cfg: MappingConfig):
    cams = {}

    def get(device) -> Camera:
        if device not in cams:
            cams[device] = _base_camera(cfg, device)
        return cams[device]
    return get


def _finish_grads(scene, params, grads, cfg):
    """Gradients as the JAX step uses them: zeros where a parameter got
    none, the key-primitive xyz freeze (train_gaussians.py:231-234), and no
    gradient for the marker (detached at all uses)."""
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    if cfg.primitive_reg:
        key = scene.marker[:, 0] > cfg.marker_thresh
        grads["xyz"] = torch.where(key[:, None],
                                   torch.zeros_like(grads["xyz"]),
                                   grads["xyz"])
    grads["marker"] = torch.zeros_like(grads["marker"])
    return grads


def make_mapping_step(cfg: MappingConfig):
    """The mapping step (train_gaussians.py map() body): render the
    window's views, back-propagate the summed loss, accumulate densify
    statistics, take one Adam step. Returns (scene, opt_state, stats, loss,
    vis_union, n_dropped [dropped, trunc, vis_overflow])."""
    camera = _camera_cache(cfg)

    def step_fn(scene: GaussianScene, opt_state: optim.AdamState,
                stats: densify.DensifyStats, frames: dict, step):
        with span("map.step.render"):
            M = scene.capacity
            V = frames["w2c"].shape[0]
            dev = scene.xyz.device
            base = camera(dev)
            params = {k: p.detach().requires_grad_(True)
                      for k, p in scene.params().items()}
            offsets = torch.zeros((V, M, 2), device=dev, requires_grad=True)
            sc = scene.with_params(params)
            ls, radii, ndrop, ntrunc, nvis = [], [], [], [], []
            for v in range(V):
                frame = {k: x[v] for k, x in frames.items()}
                out = _render_view(sc, frame, offsets[v], cfg, base)
                gt_rgb = frame["rgb"].to(torch.float32) / 255.0
                gt_depth = frame["depth_mm"].to(torch.float32) / 1000.0
                gt_score = frame["score"].to(torch.float32)
                l = losses.mapping_loss(out.image[..., :3], out.depth,
                                        gt_rgb, gt_depth,
                                        frame["exposure"][0],
                                        frame["exposure"][1],
                                        cfg.rgb_boundary_threshold)
                ls.append(l + losses.marker_loss(out.image[..., 3],
                                                 gt_score))
                radii.append(out.radii)
                ndrop.append(out.n_dropped)
                ntrunc.append(out.n_trunc)
                nvis.append(out.n_vis_dropped)
            loss = torch.sum(torch.stack(ls))
            iso = losses.isotropic_loss(torch.exp(params["scaling"]),
                                        params["marker"][:, 0], scene.alive,
                                        cfg.marker_thresh)
            if cfg.primitive_reg:
                loss = loss + cfg.isotropic_weight * iso
        # on the card the backward runs on autograd's device thread while
        # this one waits inside the call
        with span("map.step.backward"):
            *grads, off_grads = torch.autograd.grad(
                loss, list(params.values()) + [offsets], allow_unused=True)
        with span("map.step.stats"):
            radii = torch.stack(radii)
            n_dropped = torch.stack([torch.stack(ndrop).sum(),
                                     torch.stack(ntrunc).sum(),
                                     torch.stack(nvis).max()]).to(torch.int64)

            # densification stats per view (train_gaussians.py:239-245)
            for v in range(cfg.window_size):
                stats = densify.add_stats(stats, off_grads[v], radii[v],
                                          cfg.width, cfg.height)
            vis_union = torch.any(radii > 0, dim=0)
        with span("map.step.update"):
            grads = _finish_grads(scene, params, grads, cfg)
            lrs = optim.make_lrs(cfg.opt_lr_dict(), cfg.spatial_lr_scale,
                                 step)
            new_params, opt_state = optim.update(scene.params(), grads,
                                                 opt_state, lrs)
            return (scene.with_params(new_params), opt_state, stats,
                    loss.detach(), vis_union, n_dropped)

    return step_fn


def make_refinement_step(cfg: MappingConfig):
    """The color-refinement step (train_gaussians.py:269-297). Returns
    (scene, opt_state, loss, ndrop [3]); the drop counters feed the same
    host-side truncation check as the mapping step."""
    camera = _camera_cache(cfg)

    def step_fn(scene: GaussianScene, opt_state: optim.AdamState,
                frame: dict, step):
        params = {k: p.detach().requires_grad_(True)
                  for k, p in scene.params().items()}
        sc = scene.with_params(params)
        out = _render_view(sc, frame, None, cfg, camera(scene.xyz.device))
        gt_rgb = frame["rgb"].to(torch.float32) / 255.0
        loss = losses.refinement_loss(out.image[..., :3], gt_rgb,
                                      cfg.lambda_dssim)
        ndrop = torch.stack([out.n_dropped, out.n_trunc,
                             out.n_vis_dropped]).to(torch.int64)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = _finish_grads(scene, params, grads, cfg)
        lrs = optim.make_lrs(cfg.opt_lr_dict(), cfg.spatial_lr_scale, step)
        new_params, opt_state = optim.update(scene.params(), grads,
                                             opt_state, lrs)
        return scene.with_params(new_params), opt_state, loss.detach(), ndrop

    return step_fn


def _pair_need_probe(scene, camera, width: int, height: int, cfg) -> int:
    """Exact aligned pair-array need of one view (pairs.pair_need)."""
    from splatloc_tpu_torch.raster import binning, pairs, project
    proj = project.project_gaussians(
        scene.xyz, scene.scaling_activated(), scene.rotation, camera, cfg,
        alive=scene.alive, opacities=scene.opacity_activated())
    order = binning.depth_sort(proj)
    if cfg.visible_cap is not None:
        order = order[:cfg.visible_cap]
    return int(pairs.pair_need(proj.xy[order], proj.radius_xy[order],
                               proj.visible[order], width, height, cfg))


def _miscap(capacity: int) -> int:
    """Nudge a Gaussian capacity off exact 1024-multiples, as the JAX
    package does, so both size every buffer alike."""
    return capacity + 640 if capacity % 1024 == 0 else capacity


class MappingTrainer:
    """Host-side orchestrator mirroring SplatLoc.do_recon control flow.

    Random draws (the keyframe downsampling priorities and the split
    normals) come from ``self.generator``, a torch.Generator on the
    trainer's device seeded with ``seed``; the window sampling and the
    refinement frame choice use numpy's default_rng(seed), as the JAX
    package does, so both pick the same frames."""

    def __init__(self, cfg: MappingConfig, capacity: int = 2 ** 17,
                 frame_capacity: int = 512, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        capacity = _miscap(capacity)
        self.scene = GaussianScene.empty(capacity, cfg.sh_degree,
                                         device=self.device)
        self.opt_state = optim.init(self.scene.params())
        self.stats = densify.DensifyStats.zeros(capacity, self.device)
        self.frames = FrameStore(frame_capacity, cfg.height, cfg.width,
                                 self.device)
        self.iteration = 0
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.host_rng = np.random.default_rng(seed)
        self._mapping_step = make_mapping_step(cfg)
        self._refine_step = make_refinement_step(cfg)
        self._refresh_visible_cap()
        # per-step [dropped, trunc, vis_overflow] device tensors
        self._pending_dropped = []
        self.n_dropped_total = 0
        self.camera = _base_camera(cfg, self.device)

    def _rebuild_steps(self):
        self._mapping_step = make_mapping_step(self.cfg)
        self._refine_step = make_refinement_step(self.cfg)

    def _tensor(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    # -- keyframe ingestion -------------------------------------------

    def add_keyframe(self, rgb: np.ndarray, depth: np.ndarray,
                     score: np.ndarray, w2c: np.ndarray) -> int:
        """Store the frame and extend the scene from its RGB-D point cloud
        (reference add_next_kf; depth pixels with dark rgb are zeroed like
        load_depth, train_gaussians.py:299-308)."""
        rgbf = rgb.astype(np.float32)
        if rgbf.max() > 1.5:
            rgbf = rgbf / 255.0
        valid_rgb = rgbf.sum(-1) > self.cfg.rgb_boundary_threshold
        depth = np.where(valid_rgb, depth, 0.0).astype(np.float32)
        idx = self.frames.append(rgbf, depth, score, w2c)

        self._maybe_grow()
        cam = self.camera.replace_pose(self._tensor(w2c.astype(np.float32)))
        self.scene, self.opt_state, _ = init_rgbd.add_frame(
            self.scene, self.opt_state, self._tensor(rgbf),
            self._tensor(depth), self._tensor(score.astype(np.float32)),
            cam, self.generator, kp_budget=self.cfg.kp_budget,
            nonkp_budget=self.cfg.nonkp_budget,
            downsample=self.cfg.pcd_downsample,
            point_size=self.cfg.point_size,
            adaptive_pointsize=self.cfg.adaptive_pointsize)
        self._refresh_visible_cap()
        if self.cfg.pair_cap_override is not None:
            # preemptive ladder grow on the fresh frame: cheaper than a
            # drop -> escalation -> re-tighten round trip
            self._ladder_pair_cap(sample=np.asarray([idx]), shrink_ok=False)
        return idx

    def _check_pair_truncation(self):
        """Surface and bound pair truncation (build_pairs caps), checked at
        the densify cadence (a per-step check would sync the host). Every
        step since the last check is inspected in one host transfer. On any
        dropped pairs: warn, grow the caps and rebuild the steps, so silent
        under-rendering cannot persist."""
        if not self._pending_dropped:
            return
        arrs = torch.stack(self._pending_dropped).cpu().numpy()
        self._pending_dropped = []
        n = int(arrs[:, 0].sum())
        self.n_dropped_total += n
        count("map.pairs_dropped", n)
        count("map.steps_checked", len(arrs))
        dropped = int(arrs[:, 0].max())
        trunc = int(arrs[:, 1].max())
        vis = int(arrs[:, 2].max())
        if dropped == 0 and vis == 0:
            return
        old = self.cfg
        changes = {}
        if vis > 0:
            # the active-set tier overflowed: drop the cap and let the
            # refresh re-tier
            changes["visible_cap"] = None
        if trunc > 0:
            # some Gaussian overflowed the giant-splat extension tiers: grow
            # both tier pools and the tier tile caps
            T = ((-(-old.width // old.tile_size))
                 * (-(-old.height // old.tile_size)))
            changes["big_k"] = max(old.big_k * 2, 256)
            changes["mid_k"] = max(old.mid_k * 2, 4096)
            if old.big_tiles is not None:
                bt = old.big_tiles * 2
                changes["big_tiles"] = None if bt >= T else bt
            # keep mid strictly below the full tier (extension_tiers drops
            # the mid tier entirely at mid == full)
            new_full = changes.get("big_tiles", old.big_tiles) or T
            changes["mid_tiles"] = min(old.mid_tiles * 2, new_full - 1)
        if dropped > trunc:
            # global pair budget overflowed: grow it; a probe-tightened
            # override is stale evidence, so clear it
            changes["pair_cap_override"] = None
            changes["pair_cap_factor"] = old.pair_cap_factor * 2
            changes["max_per_tile"] = old.max_per_tile * 2
        self.cfg = dataclasses.replace(old, **changes)
        warnings.warn(
            f"rasterizer dropped {dropped} (gaussian, tile) pairs "
            f"({trunc} to per-Gaussian tile caps, {vis} visible Gaussians "
            f"beyond the active-set tier) at iter {self.iteration}; "
            f"escalating {changes}")
        self._rebuild_steps()

    # active-set tier fractions of capacity
    _VIS_TIERS = (0.375, 0.5, 0.625, 0.75)

    def _refresh_visible_cap(self):
        """Keep cfg.visible_cap at the smallest capacity-fraction tier above
        the alive count + insertion headroom, at every point where the
        alive count can change (init, keyframe insertion, densify), so
        n_vis_dropped stays zero by construction. Hysteresis: a cap that
        still covers the need is kept."""
        cap = self.scene.capacity
        alive = int(self.scene.num_alive)
        need = alive + max(2048, alive // 16)
        cur = self.cfg.visible_cap
        if cur is not None and need <= cur <= cap:
            return
        new = None
        for frac in self._VIS_TIERS:
            k = (int(cap * frac) // 128) * 128
            k = k + 640 if k % 1024 == 0 else k   # off-1024 (pairs.py note)
            if k >= need:
                new = min(k, cap)
                break
        if new != self.cfg.visible_cap:
            self.cfg = dataclasses.replace(self.cfg, visible_cap=new)
            self._rebuild_steps()

    def _maybe_grow(self):
        cap = self.scene.capacity
        alive = int(self.scene.num_alive)
        if alive > 0.75 * cap:
            # grow 1.5x: every sort/gather in the step scales with capacity
            new_cap = _miscap(-(-int(cap * 1.5) // 4096) * 4096)
            pad = new_cap - cap

            def grow(x):
                return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

            empty = GaussianScene.empty(new_cap, self.cfg.sh_degree,
                                        device=self.device)
            fields = {k: torch.cat([getattr(self.scene, k),
                                    getattr(empty, k)[cap:]])
                      for k in GaussianScene.PARAM_FIELDS}
            self.scene = self.scene.replace(alive=grow(self.scene.alive),
                                            **fields)
            self.opt_state = self.opt_state.replace(
                m={k: grow(x) for k, x in self.opt_state.m.items()},
                v={k: grow(x) for k, x in self.opt_state.v.items()})
            self.stats = densify.DensifyStats.zeros(new_cap, self.device)

    # -- optimization -------------------------------------------------

    def map(self, iters: int):
        """The reference map() loop: per iteration, a random window of
        keyframes, a gradient step, scheduled densify / opacity reset.
        Returns the last step's loss (one host sync per call)."""
        cfg = self.cfg
        n = self.frames.n
        V = cfg.window_size
        loss = None
        for _ in range(iters):
            self.iteration += 1
            it = self.iteration
            with span("map.step", iteration=it):
                idx = self.host_rng.permutation(n)[:V]
                if len(idx) < V:   # repeat frames if fewer than the window
                    idx = np.resize(idx, V)
                with span("map.step.gather"):
                    frames = self.frames.gather(idx)
                (self.scene, self.opt_state, self.stats, loss, vis_union,
                 n_dropped) = self._mapping_step(self.scene, self.opt_state,
                                                 self.stats, frames, it)
                self._pending_dropped.append(n_dropped)

            update = (it % cfg.gaussian_update_every
                      == cfg.gaussian_update_offset)
            if update:
                with span("map.densify", iteration=it):
                    with span("map.densify.check"):
                        self._check_pair_truncation()
                    with span("map.densify.prune"):
                        self._maybe_grow()
                        self.scene, self.stats, self.opt_state, _ = (
                            densify.densify_and_prune(
                                self.scene, self.stats, self.opt_state,
                                self.generator,
                                max_grad=cfg.densify_grad_threshold,
                                min_opacity=cfg.gaussian_th,
                                extent=cfg.gaussian_extent,
                                max_screen_size=cfg.size_threshold,
                                percent_dense=cfg.percent_dense,
                                primitive_reg=cfg.primitive_reg,
                                marker_thresh=cfg.marker_thresh))
                        self._refresh_visible_cap()
                    with span("map.densify.ladder"):
                        self._ladder_pair_cap()
            elif it % cfg.gaussian_reset == 0:
                with span("map.reset_opacity", iteration=it):
                    self.scene, self.opt_state = (
                        densify.reset_opacity_nonvisible(
                            self.scene, self.opt_state, vis_union))
        with span("map.read_loss", iteration=self.iteration):
            return None if loss is None else float(loss)

    # minimum iterations between growth-phase ladder steps (3 densify
    # cycles at the default cadence)
    _LADDER_MIN_INTERVAL = 450

    def _ladder_pair_cap(self, headroom: float = 1.4,
                         sample: np.ndarray | None = None,
                         shrink_ok: bool = True):
        """Growth-phase probe-driven pair caps: probe the exact aligned
        pair need of a keyframe sample, quantize to a coarse ladder tier,
        and step pair_cap_override between tiers with hysteresis: shrink
        only for a >=25% saving, grow preemptively when the need approaches
        the current budget."""
        from splatloc_tpu_torch.raster import pairs
        if self.frames.n == 0:
            return
        in_interval = (self.iteration - getattr(self, "_ladder_last",
                                                -10 ** 9)
                       < self._LADDER_MIN_INTERVAL)
        if sample is None:
            recent = np.arange(max(0, self.frames.n - 3), self.frames.n)
            if in_interval:
                sample = recent
            else:
                spread = np.linspace(0, self.frames.n - 1,
                                     min(5, self.frames.n), dtype=int)
                sample = np.unique(np.concatenate([recent, spread]))
        need = self._probe_pair_need(sample)
        rcfg = self.cfg.raster_config(self.device)
        n_ranks = (rcfg.visible_cap if rcfg.visible_cap is not None
                   else self.scene.capacity)
        cur = pairs.aligned_cap(rcfg, n_ranks, self.cfg.width,
                                self.cfg.height)
        q = max(2048, 1 << int(np.log2(max(need, 1) / 6 + 1)))
        target = int(np.ceil(need * headroom / q)) * q
        grow = need * 1.1 > cur           # about to overflow: raise now
        shrink = shrink_ok and target < cur * 0.75 and not in_interval
        if not (grow or shrink):
            return
        ts = self.cfg.tile_size
        T = ((-(-self.cfg.width // ts)) * (-(-self.cfg.height // ts)))
        override = max(max(target, int(need * 1.2)) - T * pairs.ALIGN,
                       pairs.ALIGN)
        self._ladder_last = self.iteration
        self.cfg = dataclasses.replace(self.cfg, pair_cap_override=override)
        self._rebuild_steps()

    def _probe_pair_need(self, frame_indices) -> int:
        """Exact aligned pair-array need (pairs.pair_need) of the current
        scene over the given keyframes, under the current raster config."""
        rcfg = self.cfg.raster_config(self.device)
        need = 0
        for i in frame_indices:
            cam = self.camera.replace_pose(self.frames.w2c[int(i)])
            need = max(need, _pair_need_probe(self.scene, cam,
                                              self.cfg.width,
                                              self.cfg.height, rcfg))
        return need

    def tighten_pair_cap(self, headroom: float = 1.25,
                         max_probe_frames: int = 16) -> bool:
        """Probe-driven static pair cap (RasterConfig.pair_cap_override):
        measure the exact aligned pair need over a sample of the stored
        keyframes and, when the current budget carries >25% slack beyond
        headroom, rebuild the steps with a near-zero-slack pair array.
        Intended at color-refinement entry. Returns True if the caps
        changed."""
        from splatloc_tpu_torch.raster import pairs
        if self.frames.n == 0:
            return False
        idx = np.unique(np.linspace(0, self.frames.n - 1,
                                    min(max_probe_frames, self.frames.n),
                                    dtype=int))
        need = self._probe_pair_need(idx)
        rcfg = self.cfg.raster_config(self.device)
        n_ranks = (rcfg.visible_cap if rcfg.visible_cap is not None
                   else self.scene.capacity)
        cur = pairs.aligned_cap(rcfg, n_ranks, self.cfg.width,
                                self.cfg.height)
        ts = self.cfg.tile_size
        T = ((-(-self.cfg.width // ts)) * (-(-self.cfg.height // ts)))
        q = max(4096, 1 << int(np.log2(max(need, 1) / 8 + 1)))
        target = int(np.ceil(need * headroom / q)) * q
        if target >= cur * 0.8:
            return False
        override = max(target - T * pairs.ALIGN, pairs.ALIGN)
        self.cfg = dataclasses.replace(self.cfg, pair_cap_override=override)
        self._rebuild_steps()
        return True

    def color_refinement(self, total_iters: int = 26000, log_every: int = 0,
                         probe_caps: bool = True):
        """L1+D-SSIM polishing over random keyframes
        (train_gaussians.py:269-297; the LR schedule restarts from 1)."""
        if probe_caps and total_iters >= 2000:
            if self.tighten_pair_cap():
                print("refinement: probe-tightened pair caps "
                      f"(override {self.cfg.pair_cap_override})")
        last = None
        for it in range(1, total_iters + 1):
            i = int(self.host_rng.integers(0, self.frames.n))
            frame = {k: x[0] for k, x in self.frames.gather([i]).items()}
            self.scene, self.opt_state, last, ndrop = self._refine_step(
                self.scene, self.opt_state, frame, it)
            self._pending_dropped.append(ndrop)
            if it % 200 == 0:
                self._check_pair_truncation()
            if log_every and it % log_every == 0:
                print(f"refine {it}: loss {float(last):.5f}")
        self._check_pair_truncation()
        return None if last is None else float(last)
