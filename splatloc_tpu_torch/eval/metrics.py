"""Evaluation metrics: PSNR / SSIM / LPIPS and pose errors.

Port of ``splatloc_tpu.eval.metrics``. Parity targets: utils/eval_utils.py
(masked PSNR over gt>0 pixels :49-51, quaternion-geodesic rotation error
:75-131, L2 translation :133-145) and the eval_rendering/eval_pose report
files, which the port writes byte for byte as the JAX package does.

LPIPS uses an AlexNet backbone + linear heads; pretrained weights cannot be
downloaded here, so ``lpips_fn`` consumes the converted-weights .npz when
available (tools/convert_lpips.py, HWIO kernels) and otherwise returns NaN
— flagged in the report rather than silently wrong. Its convs are float32
with cuDNN's TF32 off.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from splatloc_tpu_torch.core import transforms
from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.train.losses import ssim  # noqa: F401 (re-export)


def psnr_masked(image: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """PSNR over pixels where gt > 0 (any channel counts individually —
    the reference masks elementwise: image[mask] vs gt[mask])."""
    image = torch.clamp(image, 0.0, 1.0)
    mask = gt > 0
    se = torch.where(mask, (image - gt) ** 2, torch.zeros_like(gt))
    denom = torch.clamp(torch.sum(mask), min=1)
    mse = torch.sum(se) / denom
    return 20 * torch.log10(1.0 / torch.sqrt(torch.clamp(mse, min=1e-12)))


def pose_errors(pred_c2w_r: np.ndarray, pred_c2w_t: np.ndarray,
                gt_c2w: np.ndarray):
    """(rotation_deg, translation_m) — quaternion geodesic + L2
    (utils/eval_utils.py:75-145), on the host."""
    q_pred = transforms.matrix_to_quat(
        torch.as_tensor(np.asarray(pred_c2w_r, np.float32)))
    q_gt = transforms.matrix_to_quat(
        torch.as_tensor(np.asarray(gt_c2w[:3, :3], np.float32)))
    r_err = float(transforms.quat_angle_deg(q_pred, q_gt))
    t_err = float(np.linalg.norm(np.asarray(pred_c2w_t) - gt_c2w[:3, 3]))
    return r_err, t_err


# ---------------------------------------------------------------------------
# LPIPS (AlexNet)
# ---------------------------------------------------------------------------

_ALEX_CFG = [  # (out_ch, kernel, stride, padding) for the 5 conv stages
    (64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
    (256, 3, 1, 1),
]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


@full_float32()
def _alex_features(params: dict, x: torch.Tensor):
    """x [N,3,H,W] in [-1,1] -> list of 5 feature maps [N,C,h,w]."""
    feats = []
    h = x
    for i in range(5):
        _, _, stride, pad = _ALEX_CFG[i]
        h = torch.relu(F.conv2d(h, params[f"conv{i}_w"], params[f"conv{i}_b"],
                                stride=stride, padding=pad))
        feats.append(h)
        if i in (0, 1):
            h = F.max_pool2d(h, 3, 2)
    return feats


def lpips_fn(params: dict | None):
    """Returns lpips(image, gt) for [H,W,3] in [0,1]; NaN if no weights."""
    if params is None:
        return lambda a, b: float("nan")

    def fn(image, gt):
        def prep(x):
            x = x * 2.0 - 1.0
            x = ((x - torch.as_tensor(_SHIFT, device=x.device))
                 / torch.as_tensor(_SCALE, device=x.device))
            return x.permute(2, 0, 1)[None]
        fa = _alex_features(params, prep(image))
        fb = _alex_features(params, prep(gt))
        total = 0.0
        for i, (a, b) in enumerate(zip(fa, fb)):
            an = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                                 min=1e-10)
            bn = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True),
                                 min=1e-10)
            d = (an - bn) ** 2
            lin = params[f"lin{i}"]           # [C]
            total = total + torch.mean(torch.sum(d * lin[None, :, None, None],
                                                 dim=1))
        return total
    return fn


def load_lpips_params(path: str, device="cuda") -> dict | None:
    """LPIPS weights from the converted npz (HWIO), on ``device`` in the
    port's OIHW layout; None when the file is absent."""
    if not os.path.exists(path):
        return None
    from splatloc_tpu_torch import convert
    with np.load(path) as z:
        return convert.lpips_from_numpy({k: z[k] for k in z.files}, device)


def write_rendering_report(path: str, mean_psnr, mean_ssim, mean_lpips):
    """eval_rendering.txt, reference format (utils/eval_utils.py:64-70).

    mean_lpips=None (no converted LPIPS weights available) writes an
    explicit marker instead of silently averaging NaN into the report."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if mean_lpips is None:
        mean_lpips = "UNAVAILABLE (no converted LPIPS weights)"
    with open(path, "w") as f:
        f.write(f"mean_psnr: {mean_psnr}\n")
        f.write(f"mean_ssim: {mean_ssim}\n")
        f.write(f"mean_lpips: {mean_lpips}")


def write_pose_report(path: str, retrieval_t, retrieval_r, match_t, match_r,
                      n_solved: int | None = None,
                      n_failed: int | None = None):
    """eval_pose.txt, reference format (test.py:506-513). Inputs are error
    lists (meters / degrees) over ALL valid queries — failed matches carry
    the retrieval-pose fallback (test.py:318-326). Solved/failed counts are
    appended so the query population is auditable."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("Median Error: \n")
        f.write("Retrieval: Trans.(cm): {}. Rotation(deg): {}.\n".format(
            np.median(retrieval_t) * 100, np.median(retrieval_r)))
        f.write("Match    : Trans.(cm): {}. Rotation(deg): {}.\n".format(
            np.median(match_t) * 100, np.median(match_r)))
        if n_solved is not None:
            f.write("Solved: {}. Failed (retrieval fallback): {}.\n".format(
                n_solved, n_failed))
