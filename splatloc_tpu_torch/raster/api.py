"""Top-level rasterization API.

Port of ``splatloc_tpu.raster.api``: ``rasterize`` is the functional core;
``render`` mirrors the reference's render() dict contract on a
GaussianScene. The pair path (``cfg.use_pallas=True``) runs the
hand-written pair-walk kernels on CUDA tensors and their plain versions on
CPU tensors. Gradients flow through the projection and the blend (the
backward walk and the per-Gaussian reduction).
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.core import sh as sh_mod
from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, hopper_raster, project
from splatloc_tpu_torch.raster.types import RasterConfig, RenderOutput


def rasterize(
    means3d: torch.Tensor,        # [N,3]
    scales: torch.Tensor,         # [N,3] activated
    quats: torch.Tensor,          # [N,4]
    opacities: torch.Tensor,      # [N] activated (sigmoid'd)
    colors: torch.Tensor,         # [N,C] precomputed channels (RGB + extras)
    camera: Camera,
    cfg: RasterConfig = RasterConfig(),
    bg: torch.Tensor | None = None,
    alive: torch.Tensor | None = None,
    means2d_offset: torch.Tensor | None = None,
    scaling_modifier: float = 1.0,
) -> RenderOutput:
    """Gaussian rasterization on the device of the inputs.

    ``means2d_offset`` [N,2] (normally zeros) is added to the projected
    pixel centers, as in the JAX package."""
    C = colors.shape[-1]
    if bg is None:
        bg = torch.zeros((C,), dtype=torch.float32, device=colors.device)
    if not cfg.use_pallas:
        raise NotImplementedError(
            "use_pallas=False selects the tiled blend (raster/blend.py), "
            "not ported yet: ROADMAP queue A, later items")

    proj = project.project_gaussians(means3d, scales, quats, camera, cfg,
                                     alive=alive,
                                     scaling_modifier=scaling_modifier,
                                     opacities=opacities.detach())
    if means2d_offset is not None:
        proj = proj.replace(u=proj.u + means2d_offset[:, 0],
                            v=proj.v + means2d_offset[:, 1])

    order = binning.depth_sort(proj)

    acc, n_dropped, n_trunc, n_vis_dropped = hopper_raster.blend_pairs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c),
        opacities, proj.depth, colors,
        (proj.radius_x.detach(), proj.radius_y.detach()),
        proj.visible.to(torch.float32), order,
        camera.width, camera.height, cfg)
    image, depth, alpha = hopper_raster.assemble_image(
        acc, camera.width, camera.height, cfg, bg)

    return RenderOutput(image=image, depth=depth, alpha=alpha,
                        radii=proj.radius.to(torch.int32), means2d=proj.xy,
                        n_dropped=n_dropped, n_trunc=n_trunc,
                        n_vis_dropped=n_vis_dropped)


def render(scene, camera: Camera, cfg: RasterConfig = RasterConfig(),
           bg: torch.Tensor | None = None, scaling_modifier: float = 1.0,
           override_color: torch.Tensor | None = None,
           means2d_offset: torch.Tensor | None = None,
           sh_degree: int | None = None):
    """Render a GaussianScene: RGB (SH-converted, the reference's
    convert_SHs_python path) + raw kp_score as channel 3. Returns a dict
    with the reference render() keys."""
    deg = scene.sh_degree if sh_degree is None else sh_degree
    if override_color is None:
        rgb = sh_mod.sh_to_color(deg, scene.features(), scene.xyz,
                                 camera.camera_center)
    else:
        rgb = override_color
    colors = torch.cat([rgb, scene.kp_score], dim=-1)   # kp_score [M,1]
    if bg is None:
        bg = torch.zeros((colors.shape[-1],), dtype=torch.float32,
                         device=colors.device)

    out = rasterize(scene.xyz, scene.scaling_activated(), scene.rotation,
                    scene.opacity_activated(), colors, camera, cfg, bg=bg,
                    alive=scene.alive, means2d_offset=means2d_offset,
                    scaling_modifier=scaling_modifier)
    return {
        "render": out.image[..., :3],
        "kp_prob": out.image[..., 3],
        "visibility_filter": out.radii > 0,
        "radii": out.radii,
        "depth": out.depth,
        "opacity": out.alpha,
        "means2d": out.means2d,
    }


def render_features(scene, camera: Camera, feature_colors: torch.Tensor,
                    cfg: RasterConfig = RasterConfig(),
                    bg: torch.Tensor | None = None):
    """Composite arbitrary per-Gaussian feature channels [N, K] into a
    feature image. Returns dict(feature_map [H,W,K], depth, opacity)."""
    out = rasterize(scene.xyz, scene.scaling_activated(), scene.rotation,
                    scene.opacity_activated(), feature_colors, camera, cfg,
                    bg=bg, alive=scene.alive)
    return {"feature_map": out.image, "depth": out.depth,
            "opacity": out.alpha}
