"""Rasterizer configuration and output containers.

Port of ``splatloc_tpu.raster.types``: ``RasterConfig`` keeps the same
fields and defaults, so one configuration means the same render in both
packages.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Static rasterization parameters (see the JAX package's docstrings
    for the meaning of each field). Frozen and hashable."""
    tile_size: int = 16
    max_per_tile: int = 1024
    # Tiles processed per step of the tiled blend (a memory knob).
    tile_chunk: int = 64
    near: float = 0.2
    alpha_max: float = 0.99
    alpha_min: float = 1.0 / 255.0
    transmittance_eps: float = 1e-4
    cov2d_blur: float = 0.3
    # Pair path (the hand-written kernel); False selects the tiled blend.
    use_pallas: bool = False
    max_tiles: int = 12
    pair_cap_factor: int = 3
    pair_cap_override: int | None = None
    big_k: int = 256
    big_tiles: int | None = 192
    mid_k: int = 4096
    mid_tiles: int = 48
    shard_pair_margin: float = 2.0
    visible_cap: int | None = None
    aabb_binning: bool = True

    def replace(self, **changes) -> "RasterConfig":
        return dataclasses.replace(self, **changes)

    @classmethod
    def for_device(cls, device) -> "RasterConfig":
        """The JAX package's rule (``use_pallas = default_backend() !=
        "cpu"``) on a torch device: the pair kernels on the card, the tiled
        blend on the CPU."""
        return cls(use_pallas=torch.device(device).type != "cpu")


@dataclasses.dataclass(frozen=True)
class RenderOutput:
    """The reference render() contract, channels-last."""
    image: torch.Tensor        # [H, W, C]
    depth: torch.Tensor        # [H, W]      expected depth
    alpha: torch.Tensor        # [H, W]      1 - final transmittance
    radii: torch.Tensor        # [N]         screen-space radius (int32)
    means2d: torch.Tensor      # [N, 2]      pixel-space projected centers
    n_dropped: torch.Tensor    # []          pairs lost to binning caps
    n_trunc: torch.Tensor      # []          subset lost to the tile cap
    n_vis_dropped: torch.Tensor  # []        visible Gaussians beyond
    #                                        cfg.visible_cap


@dataclasses.dataclass(frozen=True)
class Projected:
    """Per-Gaussian screen-space quantities from project_gaussians, as 1-D
    components; the stacked views are properties."""
    u: torch.Tensor            # [N]    pixel x (integer-center grid)
    v: torch.Tensor            # [N]    pixel y
    depth: torch.Tensor        # [N]    view-space z
    conic_a: torch.Tensor      # [N]    inverse 2D covariance components
    conic_b: torch.Tensor      # [N]
    conic_c: torch.Tensor      # [N]
    radius: torch.Tensor       # [N]    float radius in pixels (0 => culled)
    visible: torch.Tensor      # [N]    bool
    radius_x: torch.Tensor     # [N]    per-axis binning extents
    radius_y: torch.Tensor     # [N]

    def replace(self, **changes) -> "Projected":
        return dataclasses.replace(self, **changes)

    @property
    def xy(self) -> torch.Tensor:
        return torch.stack([self.u, self.v], dim=-1)

    @property
    def conic(self) -> torch.Tensor:
        return torch.stack([self.conic_a, self.conic_b, self.conic_c],
                           dim=-1)

    @property
    def radius_xy(self) -> torch.Tensor:
        return torch.stack([self.radius_x, self.radius_y], dim=-1)
