"""Traditional new-user similarity-list construction — the paper's
baseline (PyTorch port of ``repro.core.baseline``).

For a new user u0: compute sim(u0, x) for every active user x — O(n m) —
and sort — O(n log n).  This is the path TwinSearch displaces and its
fallback when no twin verifies.  The batched burst
(``onboard_batch_traditional``) computes every burst user's similarities
in one (k, m) x (m, N) product on the hand-written similarity kernel.

The new rows are written into the arena in place (see ``core/types.py``).
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import cosine_vs_all, row_norms
from repro_torch.core.types import CFState, SENTINEL, active_mask
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.sorting import argsort_rows


def build_list(state: CFState, r0: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Similarity list of a new user vs the whole active system.

    Returns (vals_sorted_asc, idx_sorted int32, sims_unsorted), padded to
    capacity with SENTINEL for inactive slots."""
    sims = cosine_vs_all(state.ratings, state.norms, r0)
    sims = torch.where(active_mask(state), sims, SENTINEL)
    vals, idx = argsort_rows(sims)
    return vals, idx.to(torch.int32), sims


def _check_room(state: CFState, k: int) -> int:
    slot = state.n_active
    if slot + k > state.capacity:
        raise ValueError(f"arena full: {k} new rows at slot {slot} exceed "
                         f"capacity {state.capacity}")
    return slot


def append_user(state: CFState, r0: torch.Tensor, vals: torch.Tensor,
                idx: torch.Tensor) -> CFState:
    """Write the new user into the next capacity slot, in place."""
    slot = _check_room(state, 1)
    r0f = r0.float()
    state.ratings[slot] = r0f
    state.norms[slot] = torch.sqrt(torch.sum(torch.square(r0f)))
    state.sim_vals[slot] = vals
    state.sim_idx[slot] = idx.to(torch.int32)
    return state._replace(n_active=slot + 1)


def onboard_traditional(state: CFState, r0: torch.Tensor) -> CFState:
    """One new user through the traditional path (compute-all + sort)."""
    vals, idx, _ = build_list(state, r0)
    return append_user(state, r0, vals, idx)


def onboard_batch_traditional(state: CFState, R_new: torch.Tensor, *,
                              fused: bool = True) -> CFState:
    """k new users via the traditional path — the paper's O(k n m).

    ``fused=True`` (default) computes every burst user's similarities in a
    single (k, m) x (m, N) product on the similarity kernel, over the
    ratings arena with the burst already written; ``fused=False`` runs the
    users one at a time (the reference the fused path is tested against).
    Both give user t a list over exactly the rows active at its append.
    The burst must fit the free slots (the JAX reference would clamp)."""
    R_new = R_new.to(state.device)
    if not fused:
        for r0 in R_new:
            state = onboard_traditional(state, r0)
        return state

    k = R_new.shape[0]
    N = state.capacity
    slot0 = _check_room(state, k)
    Rf = R_new.float()
    state.ratings[slot0:slot0 + k] = Rf
    new_norms = row_norms(Rf)
    state.norms[slot0:slot0 + k] = new_norms

    S = cosine_similarity(Rf, state.ratings, new_norms, state.norms)
    cols = torch.arange(N, device=state.device)[None, :]
    seen = slot0 + torch.arange(k, device=state.device)[:, None]
    S = torch.where(cols < seen, S, SENTINEL)            # per-step active set
    vals, idx = argsort_rows(S)
    state.sim_vals[slot0:slot0 + k] = vals
    state.sim_idx[slot0:slot0 + k] = idx.to(torch.int32)
    return state._replace(n_active=slot0 + k)
