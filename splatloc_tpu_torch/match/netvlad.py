"""NetVLAD global image descriptor.

Port of ``splatloc_tpu.match.netvlad`` (hloc's NetVLAD retrieval network,
which the reference generates its retrieval table with,
pre_process/gen_netvlad_retrieval.py:15-42): VGG16 conv5 backbone ->
NetVLAD pooling (64 clusters, soft assignment, intra-normalized residual
aggregation) -> optional PCA whitening to 4096-d.

Weights are the JAX package's npz (HWIO kernels, ``tools/
convert_netvlad.py``), turned into torch's OIHW by
``convert.netvlad_from_numpy``. PyTorch leaves cuDNN's TF32 on by default:
the convolutions and the whitening product run in full float32, as the
JAX package computes them. The VLAD is flattened cluster-major ([K, 512]).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from splatloc_tpu_torch.core.precision import full_float32

# VGG16 conv layers up to conv5_3 (name, out_channels); pools after blocks
_VGG = [("conv1_1", 64), ("conv1_2", 64), ("pool", 0),
        ("conv2_1", 128), ("conv2_2", 128), ("pool", 0),
        ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("pool", 0),
        ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("pool", 0),
        ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512)]


def init_params(generator: torch.Generator | None = None,
                n_clusters: int = 64, whiten_dim: int | None = 4096,
                device="cuda") -> dict:
    """Random weights with the JAX package's shapes and scales, in the
    port's OIHW layout, made on ``device`` (the [64*512, 4096] whitening
    is 512 MB)."""
    def normal(shape):
        return torch.randn(shape, generator=generator, device=device)
    params = {}
    cin = 3
    for name, cout in _VGG:
        if name == "pool":
            continue
        params[f"{name}_w"] = normal((cout, cin, 3, 3)) * np.sqrt(
            2.0 / (9 * cin))
        params[f"{name}_b"] = torch.zeros((cout,), device=device)
        cin = cout
    params["vlad_centers"] = normal((n_clusters, 512))
    params["vlad_assign_w"] = normal((n_clusters, 512, 1, 1)) * 0.05
    params["vlad_assign_b"] = torch.zeros((n_clusters,), device=device)
    if whiten_dim:
        params["whiten_w"] = normal((n_clusters * 512, whiten_dim)) * 0.01
        params["whiten_b"] = torch.zeros((whiten_dim,), device=device)
    return params


def _l2(x: torch.Tensor, dim=-1) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=dim, keepdim=True),
                           min=1e-10)


@full_float32()
def global_descriptor(params: dict, image: torch.Tensor) -> torch.Tensor:
    """image [H,W,3] in [0,1] -> L2-normalized global descriptor."""
    x = image.permute(2, 0, 1)[None]
    for name, _ in _VGG:
        if name == "pool":
            x = F.max_pool2d(x, 2, 2)
        else:
            x = F.conv2d(x, params[f"{name}_w"], params[f"{name}_b"],
                         padding=1)
            if name != "conv5_3":
                x = torch.relu(x)

    # hloc NetVLAD L2-normalizes local features before pooling
    feat = _l2(x, dim=1)                                  # [1, 512, h, w]
    assign = F.conv2d(feat, params["vlad_assign_w"],
                      params["vlad_assign_b"])            # [1, K, h, w]
    assign = torch.softmax(assign, dim=1)

    centers = params["vlad_centers"]                      # [K, 512]
    f = feat[0].reshape(512, -1).T                        # [M, 512]
    a = assign[0].reshape(centers.shape[0], -1).T         # [M, K]
    # vlad[k] = sum_m a[m,k] * (f[m] - c[k])
    vlad = a.T @ f - a.sum(0)[:, None] * centers
    # intra-normalization then flatten + L2
    v = _l2(_l2(vlad).reshape(-1))
    if "whiten_w" in params:
        v = _l2(v @ params["whiten_w"] + params["whiten_b"])
    return v


def top_k_retrieval(query_descs: torch.Tensor, db_descs: torch.Tensor,
                    k: int = 10):
    """Cosine top-k (descriptors already L2-normalized).
    Returns (indices [Q,k], sims [Q,k])."""
    with full_float32():
        sims = query_descs @ db_descs.T
    vals, idx = torch.topk(sims, k, dim=-1)
    return idx, vals


def load_params(path: str, device="cuda") -> dict:
    """NetVLAD weights from the JAX package's npz (HWIO), on ``device`` in
    the port's OIHW layout."""
    from splatloc_tpu_torch import convert
    with np.load(path) as z:
        return convert.netvlad_from_numpy({k: z[k] for k in z.files}, device)
