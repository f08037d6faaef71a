"""The card's peaks and the per-operation counts the rooflines use.

NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit.
The walk counts are those of the port's on-card checks: a pair-pixel
evaluation of a walk costs OPS_PER_EVAL float32 operations (the quadratic,
the keep-eps select, the alpha cut and clamp, the transmittance test, one
exp), and a blended evaluation of the backward walk ``ops_per_blend(C)``
more.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
OPS_PER_EVAL = 16
# float32 rows of a pair record (x, y, three conic terms, opacity, depth);
# the C colour channels come on top
N_FIXED = 7


def ops_per_blend(C: int) -> int:
    """The transmittance division, u (C + 2 products and sums), w, dalpha,
    s, dpower and dop (~10), the 8 + C per-pixel terms and their 8 + C
    additions into the tile's sums."""
    return 2 + 2 * (C + 2) + 10 + 2 * (8 + C)


def bound_s(bytes_moved: float, ops: float) -> float:
    """The least time: the larger of bytes over the memory rate and
    float32 operations over their rate."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def fwd_walk_bound_s(work: dict, C: int, width: int, height: int,
                     tile: int) -> float:
    """The forward walk on one view: every pair's N_FIXED + C rows read
    once, the [T, C + 4, P] output written once; each pixel evaluates its
    tile's pairs up to its last blended pair (all where none blends)."""
    T = -(-width // tile) * -(-height // tile)
    out = T * (C + 4) * tile * tile * 4
    return bound_s((N_FIXED + C) * work["pairs"] * 4 + out + 3 * T * 4,
                   work["evals_fwd"] * OPS_PER_EVAL)


def bwd_walk_bound_s(work: dict, C: int, width: int, height: int,
                     tile: int) -> float:
    """The backward walk on one view: the rows of each tile's pairs up to
    its last blended pair read once, the forward output and the cotangent
    read once, one bfloat16 gradient row set per pair written once; each
    pixel evaluates up to its own last blended pair and blends
    ``blended`` of those."""
    T = -(-width // tile) * -(-height // tile)
    out = T * (C + 4) * tile * tile * 4
    rows = N_FIXED + C
    bytes_moved = (rows * work["needed_pairs"] * 4 + 2 * out
                   + rows * work["pairs"] * 2 + 4 * T * 4)
    ops = (work["evals_bwd"] * OPS_PER_EVAL
           + work["blended"] * ops_per_blend(C))
    return bound_s(bytes_moved, ops)
