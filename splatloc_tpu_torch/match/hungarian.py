"""Descriptor matching by optimal assignment (reference
utils/match_utils.py).

Port of ``splatloc_tpu.match.hungarian``: the auction algorithm
(Bertsekas). Each round, all unassigned rows bid for their best column in
parallel (two row-max reductions over the similarity matrix) and columns
take the highest bidder; it converges to an assignment within n*eps of the
optimum.

The JAX package runs a bounded loop of ``n_iters`` rounds, each one a
``cond`` on "any row unassigned". A converged state is a fixed point of a
round (no row bids, nothing changes), so here rounds run in blocks of
``block`` with no test inside a block and one host read of the unassigned
count per block: the same result after the same ``n_iters`` bound, with
1/block of the host syncs.

``hungarian_solve`` mirrors the reference pre/post-processing exactly:
L2-normalize both descriptor sets along the feature axis, cosine
similarity in float32 (TF32 off: the 0.4 threshold is calibrated in
float32), zero out sims < 0.4, assign on cost 1 - sim.
"""
from __future__ import annotations

import numpy as np
import torch

from splatloc_tpu_torch.core.precision import full_float32
from splatloc_tpu_torch.utils.profiling import count, span

NEG = -1e9


def _auction_round(sim, prices, owner_of_col, col_of_row, eps: float):
    """One bidding round -> (prices, owner_of_col, col_of_row)."""
    R, C = sim.shape
    dev = sim.device
    cols = torch.arange(C, device=dev)
    unassigned = col_of_row < 0                           # [R]
    value = sim - prices[None, :]                         # [R, C]
    best_val, best_col = torch.max(value, dim=1)          # first maximum
    second_val = torch.max(value.scatter(1, best_col[:, None], NEG),
                           dim=1).values
    bid = best_val - second_val + eps                     # [R]

    # each column takes its highest bidder among unassigned rows
    bids = torch.where(unassigned[:, None]
                       & (best_col[:, None] == cols[None, :]),
                       bid[:, None], torch.full_like(value, NEG))
    top_bid, top_row = torch.max(bids, dim=0)             # [C]
    won = top_bid > NEG / 2

    prices = torch.where(won, prices + top_bid, prices)
    # every write of the round is a scatter, never an index assignment: on
    # the card a mask index copies a count to the host, and an index
    # assignment of a scalar synchronizes too (torch.cuda.
    # set_sync_debug_mode shows both). Columns with no owner to evict, or
    # no winner, write to a spare slot R that is dropped, as the JAX
    # package's mode="drop" does.
    # evict previous owners of columns just won
    evicted = torch.where(won & (owner_of_col >= 0), owner_of_col, R)
    is_evicted = torch.zeros((R + 1,), dtype=torch.bool, device=dev).scatter(
        0, evicted.long(), True)
    col_of_row = torch.where(is_evicted[:R], -1, col_of_row)
    # assign winners (a row bids one column, so no write conflicts)
    slot = torch.where(won, top_row, R)
    col_of_row = torch.cat([col_of_row, col_of_row.new_full((1,), -1)])
    col_of_row = col_of_row.scatter(0, slot, cols.to(col_of_row.dtype))[:R]
    owner_of_col = torch.where(won, top_row.to(owner_of_col.dtype),
                               owner_of_col)
    return prices, owner_of_col, col_of_row


def auction_assignment(sim: torch.Tensor, eps: float = 1e-3,
                       n_iters: int = 2000, block: int = 20):
    """Maximize total similarity. sim [R, C] with R <= C.

    Returns col_of_row [R] int32 (the assigned column per row; -1 where the
    auction did not converge within ``n_iters`` rounds). Masked/forbidden
    pairs should carry a large negative value.
    """
    R, C = sim.shape
    if R > C:
        raise ValueError(f"auction needs rows <= columns, got {R} x {C}")
    prices = torch.zeros((C,), dtype=sim.dtype, device=sim.device)
    owner_of_col = torch.full((C,), -1, dtype=torch.int32, device=sim.device)
    col_of_row = torch.full((R,), -1, dtype=torch.int32, device=sim.device)
    done = 0
    while done < n_iters:
        for _ in range(min(block, n_iters - done)):
            prices, owner_of_col, col_of_row = _auction_round(
                sim, prices, owner_of_col, col_of_row, eps)
        done += min(block, n_iters - done)
        if not bool((col_of_row < 0).any()):
            break
    # the rounds issued: whole blocks of ``block`` (convergence is read
    # once a block), so it moves only when a query needs a block more or
    # fewer
    count("match.auction_rounds", done)
    return col_of_row


@full_float32()
def _sim_matrix(d1, d2, thresh: float):
    """L2-normalize along D, cosine similarity, zero below threshold
    (utils/match_utils.py:5-16)."""
    d1 = d1 / torch.clamp(torch.linalg.norm(d1, dim=0, keepdim=True),
                          min=1e-12)
    d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=0, keepdim=True),
                          min=1e-12)
    sim = d1.T @ d2
    return torch.where(sim < thresh, torch.zeros_like(sim), sim)


def _gather_wrapped(sim, idx):
    """sim[r, idx[r]] per row, with numpy's wrap of a negative index (an
    unconverged -1 reads the last column, as the JAX package's
    take_along_axis does)."""
    C = sim.shape[1]
    i = torch.where(idx < 0, idx + C, idx).long()
    return torch.gather(sim, 1, i[:, None])[:, 0]


def hungarian_solve(desc1, desc2, sim_thresh: float = 0.4, eps: float = 1e-4,
                    use_scipy: bool = False, device="cuda"):
    """desc1 [D, N1] (query), desc2 [D, N2] (train) -> (matches [2, K],
    sims [K]) as numpy arrays, K = min(N1, N2). The inputs may be numpy
    arrays or tensors; the device path computes on ``device``.

    Reference semantics (utils/match_utils.py:5-22): normalize along D,
    similarity = desc1^T desc2, zero below 0.4, solve assignment on 1 - sim.
    ``use_scipy`` switches to the host solver for diffing.
    """
    if desc1.shape[1] == 0 or desc2.shape[1] == 0:
        return np.zeros((2, 0), np.int64), np.zeros((0,), np.float32)

    if use_scipy:
        def host(x):
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            return np.asarray(x, np.float32)
        d1, d2 = host(desc1), host(desc2)
        d1 = d1 / np.maximum(np.linalg.norm(d1, axis=0, keepdims=True),
                             1e-12)
        d2 = d2 / np.maximum(np.linalg.norm(d2, axis=0, keepdims=True),
                             1e-12)
        sim = d1.T @ d2
        sim[sim < sim_thresh] = 0.0
        from scipy.optimize import linear_sum_assignment
        row, col = linear_sum_assignment(1.0 - sim)
        matches = np.stack([row, col], axis=0)
        return matches, sim[row, col]

    with span("match.similarity"):
        sim = _sim_matrix(torch.as_tensor(desc1, dtype=torch.float32,
                                          device=device),
                          torch.as_tensor(desc2, dtype=torch.float32,
                                          device=device), sim_thresh)
    if sim.shape[0] <= sim.shape[1]:
        with span("match.auction"):
            col_t = auction_assignment(sim, eps=eps)
        sims = _gather_wrapped(sim, col_t).cpu().numpy()
        col = col_t.cpu().numpy()
        row = np.arange(sim.shape[0])
    else:
        simT = sim.T
        with span("match.auction"):
            row_t = auction_assignment(simT, eps=eps)
        sims = _gather_wrapped(simT, row_t).cpu().numpy()
        row = row_t.cpu().numpy()
        col = np.arange(sim.shape[1])
    matches = np.stack([row, col], axis=0)
    return matches, sims
