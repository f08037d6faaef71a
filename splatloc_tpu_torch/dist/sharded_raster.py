"""Multi-GPU rasterization: the image's tile rows sharded over the ranks of
a mesh axis.

Port of ``splatloc_tpu.dist.sharded_raster``, the framework's sequence
parallelism: each rank bins (Gaussian, tile) pairs only for its own block
of tile rows (rects clipped to its rows), gathers only its own pair
attributes and runs the pair-walk kernels on its shard, so nothing
pair-sized is replicated or communicated. Only the O(N) per-Gaussian prep
(projection, depth sort, the attribute table) is replicated. The forward
gathers the [T, C+4, P] accumulators, which every rank needs to compute the
loss; the backward reduces each rank's per-pair gradient slab to
per-Gaussian sums locally, so its one collective is the sum of the
[N, rows] reduction (``hopper_raster._backward_impl``).

The ranks communicate through the mesh's ``torch.distributed`` groups
(``dist.multihost.Mesh``), in the backend they were made with: gloo across
processes that share one card, nccl across cards.
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.core.camera import Camera
from splatloc_tpu_torch.raster import binning, hopper_raster, project
from splatloc_tpu_torch.raster.types import RasterConfig, RenderOutput


def rasterize_sharded(means3d, scales, quats, opacities, colors,
                      camera: Camera, cfg: RasterConfig, mesh,
                      axis: str = "tile", bg=None, alive=None
                      ) -> RenderOutput:
    """Tile-sharded differentiable rasterization: the API and result of
    ``raster.rasterize`` on the pair path (``use_pallas``), on every rank
    of ``mesh``. The drop counters are summed over the ranks."""
    C = colors.shape[-1]
    if bg is None:
        bg = torch.zeros((C,), dtype=torch.float32, device=colors.device)
    proj = project.project_gaussians(means3d, scales, quats, camera, cfg,
                                     alive=alive,
                                     opacities=opacities.detach())
    order = binning.depth_sort(proj)
    acc, n_dropped, n_trunc, n_vis_dropped = hopper_raster.blend_pairs(
        (proj.u, proj.v), (proj.conic_a, proj.conic_b, proj.conic_c),
        opacities, proj.depth, colors,
        (proj.radius_x.detach(), proj.radius_y.detach()),
        proj.visible.to(torch.float32), order,
        camera.width, camera.height, cfg, mesh, axis)
    image, depth, alpha = hopper_raster.assemble_image(
        acc, camera.width, camera.height, cfg, bg)
    return RenderOutput(image=image, depth=depth, alpha=alpha,
                        radii=proj.radius.to(torch.int32), means2d=proj.xy,
                        n_dropped=n_dropped, n_trunc=n_trunc,
                        n_vis_dropped=n_vis_dropped)
