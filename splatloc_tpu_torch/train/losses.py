"""Training losses for scene mapping.

Port of ``splatloc_tpu.train.losses``:
- mapping_loss: masked L1 RGB (exposure-affine-corrected) + masked L1 depth
  (reference utils/utils.py:55-82)
- marker_loss: BCE(sigmoid(kp_prob), gt score map) (train_gaussians.py:38-42)
- isotropic_loss: scale regularizer weighted by (1 - marker) on key
  primitives (train_gaussians.py:222-228)
- refinement_loss: L1 + D-SSIM color refinement (loss_utils.py:21-22,61-69)

All images are channels-last [H,W,C], as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mapping_loss(image, depth, gt_image, gt_depth, exposure_a, exposure_b,
                 rgb_boundary_threshold: float = 0.01) -> torch.Tensor:
    """Masked L1 rgb + L1 depth with per-frame exposure affine exp(a)*I + b.

    Pixels with sum(rgb_gt) <= thresh are masked out of the RGB term; depth
    <= 0.01 out of the depth term; both terms are means over *all* pixels
    (masked entries contribute 0)."""
    image_ab = torch.exp(torch.as_tensor(exposure_a)) * image + exposure_b
    rgb_mask = (torch.sum(gt_image, dim=-1)
                > rgb_boundary_threshold)[..., None]
    depth_mask = gt_depth > 0.01
    l1_rgb = torch.abs(image_ab * rgb_mask - gt_image * rgb_mask)
    l1_depth = torch.abs(depth * depth_mask - gt_depth * depth_mask)
    return torch.mean(l1_rgb) + torch.mean(l1_depth)


def marker_loss(kp_prob_logits, gt_score) -> torch.Tensor:
    """BCE between sigmoid(composited kp channel) and the gt score map."""
    p = torch.sigmoid(kp_prob_logits.reshape(-1))
    t = gt_score.reshape(-1)
    eps = 1e-7
    p = torch.clamp(p, eps, 1 - eps)
    return -torch.mean(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def isotropic_loss(scaling, marker, alive, thresh: float = 0.005
                   ) -> torch.Tensor:
    """|mean(scale)/(0.02*(1-marker)) - 1| over key primitives
    (train_gaussians.py:222-228). marker is detached."""
    marker = marker.detach()
    mask = (marker > thresh) & alive
    target = 0.02 * (1.0 - marker)
    val = torch.abs(torch.mean(scaling, dim=-1) / target - 1.0)
    denom = torch.clamp(torch.sum(mask), min=1)
    return torch.sum(torch.where(mask, val, torch.zeros_like(val))) / denom


def _gaussian_window(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - size // 2
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / torch.sum(g)
    return torch.outer(g, g)


def ssim(img1, img2, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over [H,W,C] images: the standard 11x11 sigma=1.5 gaussian
    window formulation of the reference (loss_utils.py:25-69). The filter
    is a depthwise float32 convolution; cuDNN's TF32 is switched off, as the
    reference forces full precision (sigma^2 = E[x^2] - mu^2 cancels on
    low-variance windows)."""
    torch.backends.cudnn.allow_tf32 = False
    C = img1.shape[-1]
    w = _gaussian_window(window_size, device=img1.device)
    kernel = w[None, None].expand(C, 1, window_size, window_size)

    def filt(x):
        x = x.permute(2, 0, 1)[None]                       # NCHW
        y = F.conv2d(x, kernel, padding=window_size // 2, groups=C)
        return y[0].permute(1, 2, 0)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = filt(img1 * img1) - mu1_sq
    sigma2_sq = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) / (
        (mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2))
    return torch.mean(ssim_map)


def refinement_loss(image, gt_image, lambda_dssim: float = 0.2
                    ) -> torch.Tensor:
    """(1-l)*L1 + l*(1 - SSIM) (train_gaussians.py:285-287)."""
    l1 = torch.mean(torch.abs(image - gt_image))
    return ((1.0 - lambda_dssim) * l1
            + lambda_dssim * (1.0 - ssim(image, gt_image)))
