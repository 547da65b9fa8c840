"""Arena rotation: grow a full ``CFState`` into a larger one without
recomputing a single similarity (PyTorch port of the synchronous half of
``repro.core.rotation``; ``RotationPlan`` is not ported yet).

  * the k onboarded users' own lists already hold sim(u_t, x) for every
    base row x — their unsorted rows come back by scattering each sorted
    list through its permutation;
  * every base row receives all k new entries in one fused k-way
    merge-insert (``merge_new_users_into_base``, the list_merge kernel);
  * the burst block's mutual similarities complete by symmetry and each
    new row gains its self-entry of exactly 1;
  * ``extra`` fresh all-SENTINEL slots form the new write region.

Everything is a rearrangement of values already in the arena, so the
rotated lists are bit-identical to the reference's.  The new arena is
allocated once and filled in chunks of base rows (row-local work, so the
chunking changes no bit) to bound the temporaries on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.knn import SORT_CHUNK_ROWS
from repro_torch.core.maintenance import merge_new_users_into_base
from repro_torch.core.types import CFState, SENTINEL, SENTINEL_GATE
from repro_torch.sorting import argsort_rows


def unsorted_rows(sim_vals: torch.Tensor, sim_idx: torch.Tensor,
                  rows) -> torch.Tensor:
    """(k, N) unsorted similarity rows recovered from sorted lists by
    scattering each row's values back through its ids (-1 wraps to the
    last column, as in the reference)."""
    v = sim_vals[rows]
    i = sim_idx[rows].long()
    out = torch.full(v.shape, SENTINEL, dtype=v.dtype, device=v.device)
    out[torch.arange(v.shape[0], device=v.device)[:, None], i] = v
    return out


def _fit_width(vals: torch.Tensor, idx: torch.Tensor,
               width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad (head SENTINELs, id -1) or trim (head entries, SENTINELs by
    construction) ascending lists to ``width`` columns."""
    rows, cur = vals.shape
    if cur == width:
        return vals, idx
    if cur < width:
        pad_v = torch.full((rows, width - cur), SENTINEL, dtype=vals.dtype,
                           device=vals.device)
        pad_i = torch.full((rows, width - cur), -1, dtype=idx.dtype,
                           device=idx.device)
        return torch.cat([pad_v, vals], dim=1), torch.cat([pad_i, idx], dim=1)
    return vals[:, cur - width:], idx[:, cur - width:]


def _merge_base_rows(sim_vals: torch.Tensor, sim_idx: torch.Tensor,
                     U: torch.Tensor, rows: slice, buf_ids: torch.Tensor, *,
                     n_base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate + stable re-sort + k-way merge for the base rows ``rows``.

    Entries pointing into the write region are gated to (SENTINEL, -1),
    the gated lists are stable-sorted ascending again, and the whole burst
    merges in one pass.  Returns the merged ascending (b, L + k) lists."""
    gi_raw = sim_idx[rows]
    gate = gi_raw < n_base
    gv = torch.where(gate, sim_vals[rows], SENTINEL)
    gi = torch.where(gate, gi_raw, -1)
    gv, order = argsort_rows(gv)
    gi = torch.gather(gi, 1, order)
    return merge_new_users_into_base(gv, gi, U[:, rows], buf_ids)


def _burst_rows(U: torch.Tensor, *, n_base: int, n_frozen: int,
                n_new: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-width sorted lists for the compacted burst rows: base entries
    from the recovered block, burst-internal entries completed by symmetry
    (row u_t holds sim(u_t, u_s) only for s < t), self-entry exactly 1."""
    k = n_frozen - n_base
    C = U[:, n_base:n_frozen]
    C = torch.where(C > SENTINEL_GATE, C, C.T)
    C[torch.arange(k), torch.arange(k)] = 1.0
    W = torch.full((k, n_new), SENTINEL, dtype=torch.float32,
                   device=U.device)
    W[:, :n_base] = U[:, :n_base]
    W[:, n_base:n_frozen] = C
    bv, bi = argsort_rows(W)
    return bv, bi.to(torch.int32)


def rotate_arena_frozen(state: CFState, *, n_base: int, n_frozen: int,
                        extra: int) -> CFState:
    """Compact the frozen burst ``[n_base, n_frozen)`` into a new base
    arena of capacity ``n_active + extra``; rows ``[n_frozen, n_active)``
    are carried into the new write region with their lists re-fit to the
    new width.  ``n_frozen == n_active`` is the classic full rotation."""
    n_act = state.n_active
    k = n_frozen - n_base
    n_new = n_act + extra
    dev = state.device
    ratings = torch.zeros((n_new, state.n_items), dtype=state.ratings.dtype,
                          device=dev)
    ratings[:n_act] = state.ratings[:n_act]
    norms = torch.zeros((n_new,), dtype=state.norms.dtype, device=dev)
    norms[:n_act] = state.norms[:n_act]
    sim_vals = torch.empty((n_new, n_new), dtype=torch.float32, device=dev)
    sim_idx = torch.empty((n_new, n_new), dtype=torch.int32, device=dev)

    def fill(r0: int, r1: int, v: torch.Tensor, i: torch.Tensor) -> None:
        sim_vals[r0:r1], sim_idx[r0:r1] = _fit_width(v, i, n_new)

    if k == 0:                               # pure growth, nothing to merge
        carried_from = 0
    else:
        buf = torch.arange(n_base, n_frozen, dtype=torch.int32, device=dev)
        U = unsorted_rows(state.sim_vals, state.sim_idx, slice(n_base,
                                                               n_frozen))
        for r0 in range(0, n_base, SORT_CHUNK_ROWS):
            r1 = min(n_base, r0 + SORT_CHUNK_ROWS)
            fill(r0, r1, *_merge_base_rows(state.sim_vals, state.sim_idx, U,
                                           slice(r0, r1), buf,
                                           n_base=n_base))
        sim_vals[n_base:n_frozen], sim_idx[n_base:n_frozen] = _burst_rows(
            U, n_base=n_base, n_frozen=n_frozen, n_new=n_new)
        carried_from = n_frozen
    for r0 in range(carried_from, n_act, SORT_CHUNK_ROWS):
        r1 = min(n_act, r0 + SORT_CHUNK_ROWS)
        fill(r0, r1, state.sim_vals[r0:r1], state.sim_idx[r0:r1])

    # Fresh write region: all-SENTINEL rows with identity permutations
    # (what ``build_state`` gives inactive slots).
    sim_vals[n_act:] = SENTINEL
    sim_idx[n_act:] = torch.arange(n_new, dtype=torch.int32, device=dev)
    return CFState(ratings=ratings, norms=norms, sim_vals=sim_vals,
                   sim_idx=sim_idx, n_active=n_act)


def rotate_arena(state: CFState, *, n_base: int, extra: int,
                 headroom: float = 1.0) -> CFState:
    """Compact the write region [n_base, n_active) into a new base arena of
    capacity ``n_active + extra``.  ``headroom`` makes the fresh write
    region at least ``headroom`` times the burst just absorbed."""
    n_act = state.n_active
    k = n_act - n_base
    extra = max(int(extra), int(math.ceil(float(headroom) * k)))
    return rotate_arena_frozen(state, n_base=n_base, n_frozen=n_act,
                               extra=extra)
