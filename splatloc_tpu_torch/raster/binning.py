"""Global depth sort of the Gaussian axis.

Port of ``splatloc_tpu.raster.binning.depth_sort``. The per-tile list
builder ``tile_lists`` serves the tiled (non-pair) blend and is not ported
yet.
"""
from __future__ import annotations

import torch

from splatloc_tpu_torch.raster.types import Projected


def depth_sort(proj: Projected) -> torch.Tensor:
    """Permutation [N] sorting visible Gaussians front-to-back; invisible
    Gaussians sort to the end. Stable, as ``jnp.argsort`` is: the invisible
    ones all tie at +inf and keep their index order."""
    key = torch.where(proj.visible, proj.depth,
                      torch.full_like(proj.depth, float("inf")))
    return torch.argsort(key, stable=True)
