"""SuperPoint keypoint detector + descriptor.

Port of ``splatloc_tpu.match.superpoint`` (the architecture the reference
uses through hloc's ``superpoint_inloc`` extractor,
pre_process/extract_save_sp_feature.py:56-67): VGG-style shared encoder,
65-way cell softmax detector (8x8 cells + dustbin), 256-d descriptor head
with bilinear upsampling and L2 normalization, NMS radius 4, up to 4096
keypoints.

Weights are the JAX package's npz (HWIO kernels, ``tools/
convert_superpoint.py``), turned into torch's OIHW by
``convert.superpoint_from_numpy``. The convs are float32 with cuDNN's TF32
off: TF32 moves scores by ~1e-3 and changes the NMS survivors.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splatloc_tpu_torch.core.precision import full_float32

# (name, out_channels) of the shared encoder, pools after conv1b/2b/3b
_ENCODER = [("conv1a", 64), ("conv1b", 64), ("conv2a", 64), ("conv2b", 64),
            ("conv3a", 128), ("conv3b", 128), ("conv4a", 128),
            ("conv4b", 128)]
_POOL_AFTER = {"conv1b", "conv2b", "conv3b"}


def init_params(generator: torch.Generator | None = None,
                desc_dim: int = 256, device="cuda") -> dict:
    """Random weights with the correct shapes (OIHW), for tests and shape
    checks."""
    params = {}

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=device)
                * np.sqrt(2.0 / fan_in))
    cin = 1
    for name, cout in _ENCODER:
        params[f"{name}_w"] = normal((cout, cin, 3, 3), 9 * cin)
        params[f"{name}_b"] = torch.zeros((cout,), device=device)
        cin = cout
    heads = [("convPa", 3, 128, 256), ("convPb", 1, 256, 65),
             ("convDa", 3, 128, 256), ("convDb", 1, 256, desc_dim)]
    for name, ksz, ci, co in heads:
        params[f"{name}_w"] = normal((co, ci, ksz, ksz), ksz * ksz * ci)
        params[f"{name}_b"] = torch.zeros((co,), device=device)
    return params


def _conv(x, w, b, pad=None):
    return F.conv2d(x, w, b, padding=w.shape[-1] // 2 if pad is None else pad)


@full_float32()
def dense_outputs(params: dict, image_gray: torch.Tensor):
    """image_gray [H,W] in [0,1] (H, W multiples of 8) ->
    (scores [H,W], descriptors_coarse [H/8, W/8, D])."""
    x = image_gray[None, None]
    for name, _ in _ENCODER:
        x = torch.relu(_conv(x, params[f"{name}_w"], params[f"{name}_b"]))
        if name in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2)

    # detector head
    p = torch.relu(_conv(x, params["convPa_w"], params["convPa_b"]))
    p = _conv(p, params["convPb_w"], params["convPb_b"], pad=0)  # [1,65,h,w]
    p = torch.softmax(p, dim=1)[:, :64].permute(0, 2, 3, 1)       # drop bin
    h, w = p.shape[1], p.shape[2]
    scores = p.reshape(1, h, w, 8, 8).permute(0, 1, 3, 2, 4)
    scores = scores.reshape(h * 8, w * 8)

    # descriptor head (coarse)
    d = torch.relu(_conv(x, params["convDa_w"], params["convDa_b"]))
    d = _conv(d, params["convDb_w"], params["convDb_b"], pad=0)   # [1,D,h,w]
    d = d[0].permute(1, 2, 0)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-10)
    return scores, d


def _simple_nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Fast NMS via max-pooling (the SuperPoint reference scheme)."""
    pooled = F.max_pool2d(scores[None, None], 2 * radius + 1, stride=1,
                          padding=radius)[0, 0]
    return torch.where(scores == pooled, scores, torch.zeros_like(scores))


def _bilinear_sample(grid: torch.Tensor, xy: torch.Tensor, cell: float = 8.0):
    """Sample coarse [h,w,D] at pixel coords via align_corners-style mapping
    (the SuperPoint sample_descriptors normalization)."""
    h, w, D = grid.shape
    # pixel -> coarse coords (center of 8x8 cell at (cell-1)/2 + i*cell)
    gx = (xy[:, 0] - cell / 2 + 0.5) / cell
    gy = (xy[:, 1] - cell / 2 + 0.5) / cell
    x0 = torch.clamp(torch.floor(gx).long(), 0, w - 1)
    y0 = torch.clamp(torch.floor(gy).long(), 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    fx = torch.clamp(gx - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(gy - y0, 0.0, 1.0)[:, None]
    v = (grid[y0, x0] * (1 - fx) * (1 - fy) + grid[y0, x1] * fx * (1 - fy)
         + grid[y1, x0] * (1 - fx) * fy + grid[y1, x1] * fx * fy)
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-10)


def extract(params: dict, image_gray: torch.Tensor, max_keypoints: int = 4096,
            nms_radius: int = 4, score_threshold: float = 0.005):
    """Full extractor -> dict(keypoints [K,2] (u,v), scores [K],
    descriptors [D,K], valid [K], dense_scores [H,W])."""
    scores_dense, desc_coarse = dense_outputs(params, image_gray)
    H, W = scores_dense.shape
    nms = _simple_nms(scores_dense, nms_radius)
    # remove border keypoints (4 px, SuperPoint convention)
    border = 4
    inb = torch.zeros_like(nms, dtype=torch.bool)
    inb[border:H - border, border:W - border] = True
    nms = torch.where(inb, nms, torch.zeros_like(nms))

    flat = nms.reshape(-1)
    # a stable descending sort keeps lax.top_k's order among equal scores
    # (lower index first); small frames can hold fewer pixels than the
    # keypoint budget
    vals, idx = torch.sort(flat, descending=True, stable=True)
    k = min(max_keypoints, flat.shape[0])
    vals, idx = vals[:k], idx[:k]
    valid = vals > score_threshold
    u = (idx % W).to(torch.float32)
    v = torch.div(idx, W, rounding_mode="floor").to(torch.float32)
    kps = torch.stack([u, v], dim=-1)
    desc = _bilinear_sample(desc_coarse, kps)
    return {"keypoints": kps, "scores": vals, "descriptors": desc.T,
            "valid": valid, "dense_scores": scores_dense}


def load_params(path: str, device="cuda") -> dict:
    """SuperPoint weights from the JAX package's npz (HWIO), on ``device``
    in the port's OIHW layout."""
    from splatloc_tpu_torch import convert
    with np.load(path) as z:
        return convert.superpoint_from_numpy({k: z[k] for k in z.files},
                                             device)
