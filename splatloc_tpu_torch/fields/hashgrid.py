"""Multiresolution hash-grid encoding (tiny-cuda-nn's HashGrid).

Port of ``splatloc_tpu.fields.hashgrid``: 16 levels x 2 features, base
resolution 16, log2 hashmap size 19, per-level scale derived from the
scene's desired resolution (reference models/encoding.py:15-45). Per-level
corner indexing is dense where the level's corners fit in the table and a
spatial hash beyond, with trilinear interpolation.

The hash is the reference's uint32 multiply-and-xor with wraparound. torch
has no general uint32 arithmetic, so it runs in int64 with each product
masked to its low 32 bits: the same bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

_PRIMES = (1, 2654435761, 805459861)
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class HashGridConfig:
    n_levels: int = 16
    n_features: int = 2
    base_resolution: int = 16
    log2_hashmap_size: int = 19
    desired_resolution: int = 512

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def per_level_scale(self) -> float:
        if self.n_levels == 1:
            return 1.0
        return math.exp(math.log(self.desired_resolution /
                                 self.base_resolution) /
                        (self.n_levels - 1))

    @property
    def resolutions(self) -> tuple[int, ...]:
        s = self.per_level_scale
        return tuple(int(math.floor(self.base_resolution * s ** l))
                     for l in range(self.n_levels))

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features


def init_hashgrid(cfg: HashGridConfig, generator: torch.Generator | None = None,
                  scale: float = 1e-4, device="cuda") -> torch.Tensor:
    """Table [L, T, F], uniform(-scale, scale) like tcnn's default init."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, device=device)
    return (2.0 * u - 1.0) * scale


def _corner_index(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor,
                  res: int, table_size: int) -> torch.Tensor:
    """Grid corner (int64, in [0, res]) -> table index: dense layout when
    the level fits in the table, spatial hash otherwise (tcnn's scheme)."""
    n_corners = (res + 1) ** 3
    if n_corners <= table_size:
        return (ix * (res + 1) + iy) * (res + 1) + iz
    return _hash(ix, iy, iz) % table_size


def _hash(ix, iy, iz):
    return (((ix * _PRIMES[0]) & _U32) ^ ((iy * _PRIMES[1]) & _U32)
            ^ ((iz * _PRIMES[2]) & _U32))


# the 8 corners' (dx, dy, dz), corner c = 4 dx + 2 dy + dz
_CORNERS = [((c >> 2) & 1, (c >> 1) & 1, c & 1) for c in range(8)]


class _TableGather(torch.autograd.Function):
    """Rows ``idx`` of a [R, F] table. The backward sums each row's
    cotangents in index order on either device, so it is deterministic:
    ``index_put_`` with accumulate sorts the indices stably first on CUDA
    (the default gather's backward there, kept bit for bit), but adds them
    in thread order on a CPU with several threads; ``index_add_`` adds them
    in index order there."""

    @staticmethod
    def forward(ctx, flat, idx):
        ctx.save_for_backward(idx)
        ctx.rows = flat.shape[0]
        return flat[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        F = grad.shape[-1]
        out = grad.new_zeros((ctx.rows, F))
        idx, grad = idx.reshape(-1), grad.reshape(-1, F)
        if grad.is_cuda:
            out.index_put_((idx,), grad, accumulate=True)
        else:
            out.index_add_(0, idx, grad)
        return out, None


def encode(table: torch.Tensor, pos01: torch.Tensor,
           cfg: HashGridConfig) -> torch.Tensor:
    """pos01 [B,3] in [0,1] -> [B, L*F] features (trilinear per level).

    Every level's 8 corners are indexed at once and read with one gather
    from the flattened [L*T, F] table, so the table's gradient accumulates
    into one buffer, in a fixed order (``_TableGather``). The corners are summed one after another
    from zeros in the order 0..7, as the per-level form
    (``encode_per_level``) and the JAX package sum them: the same bits."""
    L, T, F = cfg.n_levels, cfg.table_size, cfg.n_features
    dev = pos01.device
    pos01 = torch.clamp(pos01, 0.0, 1.0)
    res_i = _device_const(cfg.resolutions, torch.int64, dev)      # [L]
    x = pos01[:, None, :] * res_i.to(pos01.dtype)[None, :, None]  # [B,L,3]
    x0 = torch.minimum(torch.clamp(torch.floor(x).to(torch.int64), min=0),
                       (res_i - 1)[None, :, None])
    w = x - x0.to(x.dtype)                                        # [B,L,3]
    d = _device_const(_CORNERS, torch.int64, dev)                 # [8,3]
    c = x0[:, :, None, :] + d                                     # [B,L,8,3]
    ix, iy, iz = c.unbind(-1)
    r1 = (res_i + 1)[None, :, None]
    dense = (ix * r1 + iy) * r1 + iz
    is_dense = _device_const([(r + 1) ** 3 <= T for r in cfg.resolutions],
                             torch.bool, dev)[None, :, None]
    idx = torch.where(is_dense, dense, _hash(ix, iy, iz) % T)
    idx = idx + (torch.arange(L, device=dev) * T)[None, :, None]
    vals = _TableGather.apply(table.reshape(L * T, F), idx)       # [B,L,8,F]
    wc = torch.where(d.bool(), w[:, :, None, :], 1 - w[:, :, None, :])
    weight = wc[..., 0] * wc[..., 1] * wc[..., 2]                 # [B,L,8]
    feats = torch.zeros((pos01.shape[0], L, F), dtype=torch.float32,
                        device=dev)
    for wc_, val in zip(weight.unbind(-1), vals.unbind(2)):
        feats = feats + wc_[..., None] * val
    return feats.reshape(pos01.shape[0], L * F)


def encode_per_level(table: torch.Tensor, pos01: torch.Tensor,
                     cfg: HashGridConfig) -> torch.Tensor:
    """``encode`` as one gather per level and corner (16 x 8 on room_0's
    grid), the JAX package's loop: the order ``encode`` keeps bit for bit.
    Kept as its reference; each gather's backward fills the whole table
    with zeros."""
    pos01 = torch.clamp(pos01, 0.0, 1.0)
    outs = []
    for l, res in enumerate(cfg.resolutions):
        x = pos01 * res                               # [B,3]
        x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, res - 1)
        w = x - x0.to(x.dtype)                        # [B,3] in [0,1]
        feats = torch.zeros((pos01.shape[0], cfg.n_features),
                            dtype=torch.float32, device=pos01.device)
        for dx, dy, dz in _CORNERS:
            idx = _corner_index(x0[:, 0] + dx, x0[:, 1] + dy, x0[:, 2] + dz,
                                res, cfg.table_size)
            weight = ((w[:, 0] if dx else 1 - w[:, 0])
                      * (w[:, 1] if dy else 1 - w[:, 1])
                      * (w[:, 2] if dz else 1 - w[:, 2]))
            feats = feats + weight[:, None] * table[l, idx]
        outs.append(feats)
    return torch.cat(outs, dim=-1)


def _device_const(values, dtype, device) -> torch.Tensor:
    """A small constant on ``device`` without a host sync: the copy from
    pageable memory is staged when it is issued, so the host goes on
    queueing (a blocking copy would wait for the device's queue)."""
    return torch.tensor(values, dtype=dtype).to(device, non_blocking=True)
