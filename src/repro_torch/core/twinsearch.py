"""TwinSearch (Lu & Shen 2015, Algorithm 1) — PyTorch port of
``repro.core.twinsearch``.

Finds an existing *twin* (identical rating row) of a new user u0 and copies
the twin's similarity list instead of recomputing it:

  1. probe:      sim(u0, u_i*) for c random probe users          O(c·m)
  2. search:     equal-range ``searchsorted`` pair in each probe's
                 ascending sorted list                            O(c·log n)
  3. intersect:  candidate bitmasks AND-reduced                   O(c·n)
  4. verify:     exact rating-row equality on <= s_max gathered
                 candidates (the paper's n/125 bound)             O(s_max·m)
  5. copy:       scatter the twin's (vals, idx) row back          O(n)

The onboarding block (rows appended after ``n_base``) is always verified,
so a burst of identical new users twins each other.

``onboard_batch_buffered`` is the other onboarding path: the burst lands
in a (k, N_base + k) write buffer over a read-only base state, and with
``maintain=True`` every base row's list gains the whole burst in one k-way
merge-insert on the ``list_merge`` kernel.

Probes come from a CPU ``torch.Generator`` (``make_probes``), so the card
and the CPU draw the same ones.  Tests that hold the port against the JAX
reference pass the JAX probes in instead.
"""
from __future__ import annotations

import torch

from repro_torch.core import baseline
from repro_torch.core.maintenance import merge_new_users_into_base
from repro_torch.core.similarity import cosine_vs_all
from repro_torch.core.types import (CFState, OnboardStats, SENTINEL,
                                    TwinResult, active_mask, as_index,
                                    set0_cap)
from repro_torch.sorting import argsort_rows, top_k
from repro_torch.spans import RECORDER


def probe_sims(state: CFState, r0: torch.Tensor, probe_idx: torch.Tensor
               ) -> torch.Tensor:
    """sim(u0, probe_i) for each of the c probes — O(c·m)."""
    return cosine_vs_all(state.ratings[probe_idx], state.norms[probe_idx],
                         r0)


def candidate_mask(state: CFState, probe_idx: torch.Tensor,
                   sims0: torch.Tensor, tol: float) -> torch.Tensor:
    """(N,) bool — Set_0 = ∩_i { x : |sim(i, x) − sim(i, 0)| <= tol }.

    Equal ranges come from a ``searchsorted`` pair on each probe's sorted
    list; the per-probe sets are scattered to user order through the list's
    ids and AND-reduced.  Ids of -1 (rotation padding, SENTINEL values,
    never in range) wrap to the last column as JAX's scatter does."""
    return mask_from_probe_rows(state.sim_vals[probe_idx],
                                state.sim_idx[probe_idx], probe_idx, sims0,
                                tol)


def mask_from_probe_rows(rows_v: torch.Tensor, rows_i: torch.Tensor,
                         probe_idx: torch.Tensor, sims0: torch.Tensor,
                         tol: float) -> torch.Tensor:
    """``candidate_mask`` from the c probes' sorted lists, however they were
    fetched: ``rows_v`` (c, N) ascending values, ``rows_i`` (c, N) ids."""
    N = rows_v.shape[1]
    c = probe_idx.shape[0]
    rows_i = rows_i.long()
    lo = torch.searchsorted(rows_v, (sims0 - tol)[:, None], side="left")
    hi = torch.searchsorted(rows_v, (sims0 + tol)[:, None], side="right")
    pos = torch.arange(N, device=rows_v.device)[None, :]
    in_range = (pos >= lo) & (pos < hi)                 # sorted order
    ar = torch.arange(c, device=rows_v.device)
    user_mask = torch.zeros((c, N), dtype=torch.bool, device=rows_v.device)
    user_mask[ar[:, None], rows_i] = in_range
    # Alg. 1 lines 5-7: a probe with sim(0, i) == 1 is itself a candidate.
    self_is_cand = torch.abs(sims0 - 1.0) <= tol
    user_mask[ar, probe_idx] = user_mask[ar, probe_idx] | self_is_cand
    return torch.all(user_mask, dim=0)


def verify_candidates(state: CFState, r0: torch.Tensor, cand: torch.Tensor,
                      s_max: int, n_base: int, k_cap: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Gather <= s_max candidate rows (+ the <= k_cap new-block rows) and
    test exact rating equality.  Returns (found, twin_idx, n_cand,
    overflowed) as 0-d tensors."""
    N = state.capacity
    dev = state.device
    cand = cand & active_mask(state)
    n_cand = torch.sum(cand)
    overflowed = n_cand > s_max
    # The s_max lowest-indexed candidates (top_k on the mask, lower index
    # first), padded with the lowest-indexed non-candidates as lax.top_k.
    _, cidx = top_k(cand.float(), s_max)
    valid = cand[cidx]
    if k_cap > 0:
        blk = n_base + torch.arange(k_cap, device=dev)
        cidx = torch.cat([cidx, torch.clamp(blk, max=N - 1)])
        valid = torch.cat([valid, blk < state.n_active])
    rows = state.ratings[cidx]
    eq = torch.all(rows == r0.to(rows.dtype)[None, :], dim=1) & valid
    found = torch.any(eq)
    twin_idx = cidx[torch.argmax(eq.to(torch.uint8))]
    return found, twin_idx, n_cand, overflowed


def twinsearch_find(state: CFState, r0: torch.Tensor, probe_idx, *,
                    s_max: int, n_base: int = 0, k_cap: int = 0,
                    tol: float = 1e-6) -> TwinResult:
    """Algorithm 1, lines 1-15: find a verified twin of ``r0`` (no copy)."""
    probe_idx = as_index(probe_idx, state.device)
    r0 = r0.to(state.device)
    sims0 = probe_sims(state, r0, probe_idx)
    cand = candidate_mask(state, probe_idx, sims0, tol)
    found, twin_idx, n_cand, overflowed = verify_candidates(
        state, r0, cand, s_max, n_base, k_cap)
    return TwinResult(found=found, twin_idx=twin_idx, n_candidates=n_cand,
                      overflowed=overflowed, probe_sims=sims0)


def onboard_twinsearch(state: CFState, r0: torch.Tensor, probe_idx, *,
                       s_max: int, n_base: int = 0, k_cap: int = 0,
                       tol: float = 1e-6) -> tuple[CFState, TwinResult]:
    """One new user through TwinSearch with traditional fallback, appended
    in place.

    If a twin verifies, its list is scattered back to user order — O(n) —
    and the onboarding block's entries (users added after the twin's list
    was built) are recomputed at O(k·m), so the copy is exactly what a
    traditional build would give.  Otherwise, including a not-found
    overflow, the traditional O(n·m) build runs.

    Spans: ``twinsearch.search`` (the search up to the found flag's read),
    then ``twinsearch.copy`` or ``baseline.fallback``, each with its sort
    and append."""
    r0 = r0.to(state.device)
    with RECORDER.span("twinsearch.search"):
        res = twinsearch_find(state, r0, probe_idx, s_max=s_max,
                              n_base=n_base, k_cap=k_cap, tol=tol)
        found = bool(res.found)
    N = state.capacity
    if found:
        with RECORDER.span("twinsearch.copy"):
            tidx = state.sim_idx[res.twin_idx].long()
            u = torch.full((N,), SENTINEL, dtype=state.sim_vals.dtype,
                           device=state.device)
            u[tidx] = state.sim_vals[res.twin_idx]
            if k_cap > 0:
                blk = torch.clamp(n_base + torch.arange(k_cap,
                                                        device=state.device),
                                  max=N - 1)
                u[blk] = cosine_vs_all(state.ratings[blk], state.norms[blk],
                                       r0)
            return _append_row(state, r0, u), res
    with RECORDER.span("baseline.fallback"):
        return _append_row(state, r0,
                           cosine_vs_all(state.ratings, state.norms, r0)), res


def _append_row(state: CFState, r0: torch.Tensor,
                sims_row: torch.Tensor) -> CFState:
    """Append ``r0`` with the list of its unsorted similarity row (inactive
    slots masked to SENTINEL)."""
    sims_row = torch.where(active_mask(state), sims_row, SENTINEL)
    vals, idx = argsort_rows(sims_row)
    return baseline.append_user(state, r0, vals, idx)


def onboard_batch(state: CFState, R_new: torch.Tensor, probe_idx, *,
                  s_max: int | None = None, tol: float = 1e-6,
                  set0_divisor: int = 125, set0_slack: float = 1.5
                  ) -> tuple[CFState, OnboardStats]:
    """k new users via TwinSearch — the paper's O((1 + (k−1)/125)·m·n).

    ``R_new``: (k, m); ``probe_idx``: (k, c).  The arena's capacity was
    sized n + k, so ``n_base = capacity - k`` and the whole burst is the
    always-verified new block."""
    k = R_new.shape[0]
    n_base = state.capacity - k
    if s_max is None:
        s_max = set0_cap(n_base, set0_divisor, set0_slack)
    R_new = R_new.to(state.device)
    probe_idx = as_index(probe_idx, state.device)
    outs = []
    for t in range(k):
        state, res = onboard_twinsearch(state, R_new[t], probe_idx[t],
                                        s_max=s_max, n_base=n_base, k_cap=k,
                                        tol=tol)
        outs.append((res.found, res.twin_idx, res.n_candidates,
                     res.overflowed))
    found, twin, ncand, ovf = (torch.stack(x) for x in zip(*outs))
    return state, OnboardStats(found=found, twin_idx=twin,
                               n_candidates=ncand, overflowed=ovf)


def make_probes(gen: torch.Generator, k: int, c: int, n_base: int
                ) -> torch.Tensor:
    """(k, c) random probe indices over the base population (line 1), from
    a CPU generator so every device draws the same probes."""
    return torch.randint(0, n_base, (k, c), generator=gen)


def onboard_batch_buffered(state: CFState, R_new: torch.Tensor, probe_idx,
                           *, s_max: int, tol: float = 1e-6,
                           maintain: bool = False):
    """An onboarding burst over an **immutable** base state.

    The base state (ratings, sorted lists) is only read; the burst's rows
    accumulate **unsorted** in a (k, N_base + k) buffer, all SENTINEL at
    first (entry N_base + s is burst user s, filled for s < t);
    burst-internal twins verify directly against ``R_new``, the first
    earlier twin winning; a twin's id is ``N_base + s``; all k rows sort
    once, stably, at the end.

    Returns (vals (k, N_tot) ascending, idx (k, N_tot) int32, stats); with
    ``maintain=True`` a fourth element (base_vals, base_idx): every base
    row's list re-sorted to width N_tot with all k new users merged in by
    one k-way merge-insert (the ``list_merge`` kernel), fed from the write
    buffer's base columns at zero extra similarity compute.

    The reference's ``unroll``, ``rows_spec`` and ``use_pallas`` arguments
    are dropped: eager PyTorch has no scan to unroll or sharding to name,
    and the merge runs the kernel on the card and its plain version on
    the CPU."""
    N_base = state.capacity
    dev = state.device
    R_new = R_new.to(dev)
    probe_idx = as_index(probe_idx, dev)
    k = R_new.shape[0]
    N_tot = N_base + k
    Rn = R_new.float()
    new_norms = torch.sqrt(torch.sum(torch.square(Rn), dim=1))
    karange = torch.arange(k, device=dev)

    buf = torch.full((k, N_tot), SENTINEL, dtype=torch.float32, device=dev)
    outs = []
    for j in range(k):
        r0 = R_new[j]
        sims0 = probe_sims(state, r0, probe_idx[j])
        cand = candidate_mask(state, probe_idx[j], sims0, tol)
        found_b, twin_b, n_cand, ovf = verify_candidates(
            state, r0, cand, s_max, 0, 0)

        # Burst-internal twins: verify against R_new directly.
        live = karange < j
        eq_new = torch.all(R_new == r0[None, :], dim=1) & live
        found_n = torch.any(eq_new)
        twin_n = torch.argmax(eq_new.to(torch.uint8))

        # Block sims are needed on every path (the copied row must carry
        # entries for previously-added burst users) — O(k·m).
        bsims = cosine_vs_all(Rn, new_norms, r0.float())
        buf[j, N_base:] = torch.where(live, bsims, SENTINEL)
        if bool(found_b):
            u = torch.full((N_base,), SENTINEL, dtype=torch.float32,
                           device=dev)
            u[state.sim_idx[twin_b].long()] = state.sim_vals[twin_b].float()
            buf[j, :N_base] = u
        elif bool(found_n):
            buf[j, :N_base] = buf[twin_n, :N_base]
        else:
            buf[j, :N_base] = cosine_vs_all(state.ratings, state.norms, r0)
        outs.append((found_b | found_n,
                     torch.where(found_b, twin_b, N_base + twin_n),
                     n_cand, ovf))

    vals, idx = argsort_rows(buf)
    found, twin, ncand, ovf = (torch.stack(x) for x in zip(*outs))
    stats = OnboardStats(found=found, twin_idx=twin, n_candidates=ncand,
                         overflowed=ovf)
    if not maintain:
        return vals, idx.to(torch.int32), stats
    maintained = merge_new_users_into_base(
        state.sim_vals, state.sim_idx, buf[:, :N_base], N_base + karange)
    return vals, idx.to(torch.int32), stats, maintained
