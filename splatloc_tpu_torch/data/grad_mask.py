"""Scharr-gradient edge mask (reference utils/camera_utils.py:145-172).

Port of ``splatloc_tpu.data.grad_mask``, carried for capability parity:
the reference computes it per keyframe (train_gaussians.py:329) as a
vestigial MonoGS tracking hook; the SplatLoc mapping losses never consume
it. The reference's 32x32 Python block loop is one reshape and a
per-block median.

The median is ``jnp.median``'s: the mean of the two middle values of an
even count (``torch.median`` returns the lower one). The Replica blocks at
480x640 hold 300 values, the whole image 307,200: both even.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from splatloc_tpu_torch.core.precision import full_float32


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, the two middle values averaged for an
    even count (as ``jnp.median``: (lo + hi) * 0.5)."""
    s = torch.sort(x, dim=-1).values
    n = s.shape[-1]
    return (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5


@full_float32()
def compute_grad_mask(rgb: torch.Tensor, edge_threshold: float = 4.0,
                      dataset_type: str = "replica", rows: int = 32,
                      cols: int = 32) -> torch.Tensor:
    """rgb [H,W,3] in [0,1] -> edge mask [H,W] (1 = high-gradient pixel)."""
    gray = torch.mean(rgb, dim=-1)
    scharr_x = torch.tensor([[-3, 0, 3], [-10, 0, 10], [-3, 0, 3]],
                            dtype=torch.float32, device=rgb.device) / 32.0
    k = torch.stack([scharr_x, scharr_x.T])[:, None]          # [2,1,3,3]
    g = F.conv2d(gray[None, None], k, padding=1)[0]           # [2,H,W]
    inten = torch.sqrt(g[0] * g[0] + g[1] * g[1])

    H, W = gray.shape
    if dataset_type == "replica" and H % rows == 0 and W % cols == 0:
        bh, bw = H // rows, W // cols
        blocks = inten.reshape(rows, bh, cols, bw).permute(0, 2, 1, 3)
        med = _median(blocks.reshape(rows, cols, -1))
        thr = (med * edge_threshold)[:, :, None, None]
        mask = (blocks > thr).to(torch.float32)
        return mask.permute(0, 2, 1, 3).reshape(H, W)
    med = _median(inten.reshape(-1))
    return (inten > med * edge_threshold).to(torch.float32)
