"""Sorted-list maintenance: making freshly onboarded users visible in every
existing user's ascending similarity list (PyTorch port of
``repro.core.maintenance``).

  * traditional path — ``sims`` (the new user's similarity to everyone)
    was just computed, so row x inserts sims[x] at its searchsorted
    position;
  * twin path — sim(x, u0) == sim(x, twin), which already sits in row x,
    so the insert duplicates the twin's entry ("twin splice") with no new
    similarity computation.

A burst of k users lands in one fused k-way merge-insert
(``kernels/list_merge``): O(N·(N + k)) instead of k·O(N²).  Inserts apply
in burst order and row x takes the insert for new user u_t iff x < u_t,
which reproduces the interleaved flow ``for t: append_user(u_t);
insert_into_lists(u_t)`` element for element.  The buffered bursts'
merge into a read-only base (``merge_new_users_into_base``) is the same
kernel's rotation entry, ``merge_rows``, with nothing gated.  Everything
here is data movement, so results are bit-identical to the reference.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import CFState, as_index
from repro_torch.kernels.list_merge.ops import merge_insert, merge_rows


def insert_batch_into_lists(state: CFState, new_users: torch.Tensor,
                            sims_block: torch.Tensor) -> CFState:
    """Merge a burst of k new users into every active row's list at once.

    ``new_users``: (k,) slot ids in append order; ``sims_block``: (k, N),
    sims_block[t, x] = sim(u_t, x).  Row x takes insert t iff
    x < new_users[t]."""
    N = state.capacity
    new_users = as_index(new_users, state.device).to(torch.int32)
    rows = torch.arange(N, device=state.device)[:, None]
    mask = rows < new_users[None, :]
    vals, idx = merge_insert(state.sim_vals, state.sim_idx,
                             sims_block.T.float(), new_users, mask)
    return state._replace(sim_vals=vals, sim_idx=idx)


def insert_into_lists(state: CFState, new_user: int,
                      sims: torch.Tensor) -> CFState:
    """Insert one ``new_user`` into every active row's ascending list (the
    k=1 case of the batched merge, gated to ``(row < n_active) & (row !=
    new_user)``)."""
    N = state.capacity
    rows = torch.arange(N, device=state.device)
    live = (rows < state.n_active) & (rows != int(new_user))
    ids = torch.tensor([int(new_user)], dtype=torch.int32,
                       device=state.device)
    vals, idx = merge_insert(state.sim_vals, state.sim_idx,
                             sims[:, None].float(), ids, live[:, None])
    return state._replace(sim_vals=vals, sim_idx=idx)


def twin_sims_block(state: CFState, twins: torch.Tensor) -> torch.Tensor:
    """(k, N) sims gathered from each row's stored twin entries — the twin
    splice's input, computed without any similarity arithmetic.  One O(N²)
    scatter inverts every row's permutation; each twin is then a gather."""
    N = state.capacity
    dev = state.device
    rows = torch.arange(N, device=dev)[:, None]
    cols = torch.arange(N, dtype=torch.int32, device=dev).expand(N, N)
    inv = torch.zeros((N, N), dtype=torch.int32, device=dev)
    inv[rows, state.sim_idx.long()] = cols
    pos = inv[:, as_index(twins, dev)]   # (N, k)
    return torch.gather(state.sim_vals, 1, pos.long()).T


def splice_twins(state: CFState, new_users: torch.Tensor,
                 twins: torch.Tensor) -> CFState:
    """Twin-path maintenance for a whole burst: row x's value for new user
    u_t equals its stored value for twins[t]."""
    return insert_batch_into_lists(state, new_users,
                                   twin_sims_block(state, twins))


def splice_twin(state: CFState, new_user: int, twin: int) -> CFState:
    """Single-user twin-path maintenance: gathers sim(x, twin) from each
    row and defers to the shared insert."""
    hit = state.sim_idx == int(twin)
    pos = torch.argmax(hit.to(torch.uint8), dim=1)
    sims = torch.gather(state.sim_vals, 1, pos[:, None])[:, 0]
    return insert_into_lists(state, new_user, sims)


def merge_new_users_into_base(base_vals: torch.Tensor, base_idx: torch.Tensor,
                              sims_block: torch.Tensor,
                              new_user_ids: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Extend each of the Nb base rows' (Nb, L) lists by k head SENTINELs
    (id -1) and merge the burst in: the k real inserts consume exactly the
    k SENTINELs, so the (Nb, L + k) result holds every original entry plus
    one entry per new user, without writing the base state.

    ``sims_block``: (k, Nb), sims_block[t, x] = sim(u_t, base row x);
    ``new_user_ids``: (k,) ids the merged entries carry.  One
    ``list_merge`` ``merge_rows`` launch writes the output: with ``n_base``
    L, above every id a list holds, nothing is gated, and the stable
    partition leaves a list with no value below SENTINEL as it is."""
    Nb, L = base_vals.shape
    k = sims_block.shape[0]
    dev = base_vals.device
    ids = as_index(new_user_ids, dev).to(torch.int32)
    out_v = torch.empty((Nb, L + k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Nb, L + k), dtype=torch.int32, device=dev)
    return merge_rows(base_vals, base_idx.to(torch.int32), sims_block.float(),
                      ids, slice(0, Nb), out_v, out_i, n_base=L)
