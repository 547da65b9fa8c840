"""Arena rotation: grow a full ``CFState`` into a larger one without
recomputing a single similarity (PyTorch port of ``repro.core.rotation``).

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

Two modes share the per-row merge and the assembly, so they agree bit for
bit: ``rotate_arena`` (one shot, now) and ``RotationPlan`` (merge the base
rows in bounded slices between requests, then an atomic swap).
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.knn import SORT_CHUNK_ROWS
from repro_torch.core.maintenance import merge_new_users_into_base
from repro_torch.core.types import CFState, SENTINEL, SENTINEL_GATE
from repro_torch.sorting import argsort_rows
from repro_torch.spans import RECORDER


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


def merge_base_rows(sim_vals: torch.Tensor, sim_idx: torch.Tensor,
                     U: torch.Tensor, rows, buf_ids: torch.Tensor, *,
                     n_base: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gate + stable re-sort + k-way merge for the base rows ``rows`` (a
    slice, or an index tensor of row ids below ``n_base``).

    Entries pointing into the write region are gated to (SENTINEL, -1),
    the gated lists are stable-sorted ascending again, and the whole burst
    merges in one pass.  Returns the merged ascending (b, L + k) lists."""
    with RECORDER.span("rotation.merge", device=sim_vals.is_cuda):
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


def _assemble(state: CFState, *, n_base: int, n_frozen: int, extra: int,
              U: torch.Tensor | None, merged) -> CFState:
    """The rotated arena of capacity ``n_active + extra``.  Base rows
    ``[0, n_base)`` take ``merged(r0, r1)``, the merged (r1 - r0, L + k)
    lists of those rows; the burst ``[n_base, n_frozen)`` is built from the
    recovered block ``U``; rows ``[n_frozen, n_active)`` are carried.  Both
    rotation modes assemble through here, so they agree bit for bit.

    Two ``rotation.assemble`` spans lie beside the merges
    (``rotation.merge``): the allocation with the ratings' and norms'
    copies, and the burst, carried and write-region rows; the merged rows'
    copies lie between the merges."""
    n_act = state.n_active
    k = n_frozen - n_base
    n_new = n_act + extra
    dev = state.device
    on_card = dev.type == "cuda"
    with RECORDER.span("rotation.assemble", device=on_card):
        ratings = torch.zeros((n_new, state.n_items),
                              dtype=state.ratings.dtype, device=dev)
        ratings[:n_act] = state.ratings[:n_act]
        norms = torch.zeros((n_new,), dtype=state.norms.dtype, device=dev)
        norms[:n_act] = state.norms[:n_act]
        sim_vals = torch.empty((n_new, n_new), dtype=torch.float32,
                               device=dev)
        sim_idx = torch.empty((n_new, n_new), dtype=torch.int32, device=dev)

    def fill(r0: int, r1: int, v: torch.Tensor, i: torch.Tensor) -> None:
        sim_vals[r0:r1], sim_idx[r0:r1] = _fit_width(v, i, n_new)

    if k == 0:                               # pure growth, nothing to merge
        carried_from = 0
    else:
        for r0 in range(0, n_base, SORT_CHUNK_ROWS):
            r1 = min(n_base, r0 + SORT_CHUNK_ROWS)
            fill(r0, r1, *merged(r0, r1))
        carried_from = n_frozen
    with RECORDER.span("rotation.assemble", device=on_card):
        if k:
            sim_vals[n_base:n_frozen], sim_idx[n_base:n_frozen] = \
                _burst_rows(U, n_base=n_base, n_frozen=n_frozen,
                            n_new=n_new)
        for r0 in range(carried_from, n_act, SORT_CHUNK_ROWS):
            r1 = min(n_act, r0 + SORT_CHUNK_ROWS)
            fill(r0, r1, state.sim_vals[r0:r1], state.sim_idx[r0:r1])
        # Fresh write region: all-SENTINEL rows with identity permutations
        # (what ``build_state`` gives inactive slots).
        sim_vals[n_act:] = SENTINEL
        sim_idx[n_act:] = torch.arange(n_new, dtype=torch.int32, device=dev)
    return CFState(ratings=ratings, norms=norms, sim_vals=sim_vals,
                   sim_idx=sim_idx, n_active=n_act)


def rotate_arena_frozen(state: CFState, *, n_base: int, n_frozen: int,
                        extra: int) -> CFState:
    """Compact the frozen burst ``[n_base, n_frozen)`` into a new base
    arena of capacity ``n_active + extra``; rows ``[n_frozen, n_active)``
    are carried into the new write region with their lists re-fit to the
    new width — valid because onboarding only ever writes the new user's
    own row.  ``n_frozen == n_active`` is the classic full rotation.  This
    is also the deterministic replay of a WAL ``rotate_commit`` record."""
    U = merged = None
    if n_frozen > n_base:
        with RECORDER.span("rotation.recover"):
            buf = torch.arange(n_base, n_frozen, dtype=torch.int32,
                               device=state.device)
            U = unsorted_rows(state.sim_vals, state.sim_idx,
                              slice(n_base, n_frozen))

        def merged(r0: int, r1: int):
            return merge_base_rows(state.sim_vals, state.sim_idx, U,
                                    slice(r0, r1), buf, n_base=n_base)
    return _assemble(state, n_base=n_base, n_frozen=n_frozen, extra=extra,
                     U=U, merged=merged)


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


class RotationPlan:
    """Chunked, resumable arena rotation with a frozen burst boundary.

    Created when the server decides to rotate *ahead* of exhaustion: the
    expensive part — gating and merging every base row — runs in bounded
    slices (``step``) between requests, and the cheap remainder (burst rows,
    carried rows, assembly) runs once at ``finalize``.  The plan never
    writes the state it reads, and a crash mid-plan loses nothing (nothing
    is logged until the swap commits).

    The port writes the arena in place, so the plan stays correct only
    because every write to a row below ``n_frozen`` is reported:

      * onboarding writes only the new user's row, at or past ``n_frozen``,
        and ``finalize`` carries those rows from the live state;
      * ``add_rating`` reports its row through ``note_write``: a base row
        is marked dirty and re-merged from the live state before the swap;
        a frozen burst row makes the recovered block stale, and the
        precompute restarts from the live state (same boundary).

    ``finalize`` is therefore bit-identical to ``rotate_arena_frozen``
    applied to the live state at swap time, which is what crash recovery
    replays from the WAL's ``rotate_commit`` record.  The (n_base, L + k)
    merge accumulators live on the state's device (8.6 GB at 32,768 base
    rows), so the swap copies them on the card; the reference keeps them
    in host memory.  Eager PyTorch needs no fixed chunk shape, so a slice
    is not padded to ``chunk_rows`` as the reference's jitted merge is.
    """

    def __init__(self, state: CFState, *, n_base: int, extra: int,
                 chunk_rows: int = 64):
        self.n_base = int(n_base)
        self.n_frozen = int(state.n_active)
        self.k = self.n_frozen - self.n_base
        self.extra = int(extra)
        self.chunk = max(1, int(chunk_rows))
        self.restarts = 0
        self.elapsed_ms = 0.0        # accumulated step + finalize time
        self._device = state.device
        self._buf = torch.arange(self.n_base, self.n_frozen,
                                 dtype=torch.int32, device=self._device)
        self._U: torch.Tensor | None = None
        self._mv: torch.Tensor | None = None     # (n_base, L + k)
        self._mi: torch.Tensor | None = None
        self._cursor = 0
        self._dirty: set[int] = set()
        self._stale = self.k > 0     # U snapshot pending (or invalidated)

    # -- progress -----------------------------------------------------------

    @property
    def done(self) -> bool:
        """True when every base row is merged against the current block
        and no dirty rows are pending."""
        if self.k == 0:
            return True
        return (not self._stale and self._cursor >= self.n_base
                and not self._dirty)

    @property
    def remaining_rows(self) -> int:
        if self.k == 0:
            return 0
        if self._stale:
            return self.n_base + len(self._dirty)
        return (self.n_base - self._cursor) + len(self._dirty)

    # -- live-mutation reconciliation ---------------------------------------

    def note_write(self, row: int) -> None:
        """Record that ``row``'s list/ratings were rewritten (add_rating)."""
        r = int(row)
        if r < self.n_base:
            if not self._stale:      # a pending refreeze re-reads everything
                self._dirty.add(r)
        elif r < self.n_frozen:
            if not self._stale:
                self._stale = True
                self.restarts += 1

    # -- bounded work -------------------------------------------------------

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _refreeze(self, state: CFState) -> None:
        self._U = unsorted_rows(state.sim_vals, state.sim_idx,
                                slice(self.n_base, self.n_frozen))
        if self._mv is None:
            width = state.sim_vals.shape[1] + self.k
            self._mv = torch.empty((self.n_base, width), dtype=torch.float32,
                                   device=self._device)
            self._mi = torch.empty((self.n_base, width), dtype=torch.int32,
                                   device=self._device)
        self._cursor = 0
        self._dirty.clear()
        self._stale = False

    def _run_rows(self, state: CFState, rows) -> None:
        self._mv[rows], self._mi[rows] = merge_base_rows(
            state.sim_vals, state.sim_idx, self._U, rows, self._buf,
            n_base=self.n_base)

    def step(self, state: CFState, budget_rows: int) -> int:
        """Merge up to ``budget_rows`` base rows against the frozen block;
        returns the number of rows processed.  Never writes ``state``; safe
        to call at any point between server mutations."""
        if self.k == 0 or self.done:
            return 0
        t0 = time.perf_counter()
        if self._stale:
            self._refreeze(state)
        budget = max(1, int(budget_rows))
        processed = 0
        while processed < budget and self._cursor < self.n_base:
            hi = min(self._cursor + self.chunk, self.n_base)
            self._run_rows(state, slice(self._cursor, hi))
            processed += hi - self._cursor
            self._cursor = hi
        # Main sweep finished: re-merge rows dirtied since they were done.
        while (processed < budget and self._cursor >= self.n_base
               and self._dirty):
            batch = sorted(self._dirty)[:self.chunk]
            self._run_rows(state, torch.tensor(batch, device=self._device))
            self._dirty.difference_update(batch)
            processed += len(batch)
        self._sync()
        self.elapsed_ms += (time.perf_counter() - t0) * 1e3
        return processed

    # -- the atomic swap ----------------------------------------------------

    def finalize(self, state: CFState) -> CFState:
        """The rotated state from the live ``state``: drain any remaining
        or dirty rows, then assemble.  Bit-identical to
        ``rotate_arena_frozen(state, n_base=.., n_frozen=.., extra=..)``."""
        while not self.done:                     # force-drain the tail
            self.step(state, self.n_base)
        t0 = time.perf_counter()
        out = _assemble(state, n_base=self.n_base, n_frozen=self.n_frozen,
                        extra=self.extra, U=self._U,
                        merged=lambda r0, r1: (self._mv[r0:r1],
                                               self._mi[r0:r1]))
        self._sync()
        self.elapsed_ms += (time.perf_counter() - t0) * 1e3
        return out
