"""Distributed TwinSearch on ``torch.distributed`` — the web-scale
onboarding path (PyTorch port of ``repro.core.twinsearch_sharded``).

The arena is row-sharded over the ranks of a process group: rank r holds
rows [r·N/w, (r+1)·N/w) of ``ratings``, ``norms``, ``sim_vals`` and
``sim_idx`` (``distributed.sharding.local_state``); the burst and its
probes are replicated.  Every access to another rank's rows is an explicit
collective:

  * probe rows and a base twin's row: each rank contributes its rows of
    the request and -0.0 (ids: 0) for the others, and one ``all_reduce``
    (SUM) assembles them.  x + (-0.0) == x for every float x, so the rows
    arrive bit for bit from their owner; ids travel as int32, exact at
    any arena size (the reference sends them as float32, exact below
    2^24 rows);
  * candidate verification is **rank-local**: each rank gathers only its
    own candidate rows, lower index first, and contributes a count, a
    found flag and an overflow flag (``all_reduce`` SUM) and its lowest
    verified id (``all_reduce`` MAX).  As in the reference's ``pmax``, the
    twin is the **last** rank's that verifies one, not the lowest id
    overall;
  * the traditional fallback: a rank-local mat-vec and one
    ``all_gather_into_tensor`` of the N similarities;
  * the burst accumulates in a replicated (k, N+k) write buffer; the base
    arena is never written.  ``maintain=True`` merges the burst into this
    rank's base rows (the ``list_merge`` kernel on the card), with no
    further collective.

Per user, the collectives carry the tensors they are called with (for the
gather, its N-entry output): the c probe lists, 2·c·N·4 bytes, the c probe
sims, 4·c, and the counters, 16; then a base twin's list, 2·N·4, or a
fallback's gathered row, N·4, or nothing for a twin inside the burst.  For
a base twin that is (2c+2)·N·4 + 4c + 16 bytes (``payload_bytes``): at
c = 8 and N = 32,768, 2.36 MB.  The reference's docstring claims about
(c+2)·N·4; its code moves what this one does, ids as float32.

Without an initialised process group every entry point raises: nothing
here falls back to the unsharded burst (``twinsearch.onboard_batch_
buffered``).  The shards are the reference's ``axes`` of a ``DeviceMesh``
``mesh`` (every axis when ``axes`` is None); without a mesh, the ranks of
the default process group.  The shard id is the rank in that group.  The
reference's ``unroll`` is dropped.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.maintenance import merge_new_users_into_base
from repro_torch.core.rotation import unsorted_rows
from repro_torch.core.similarity import cosine_vs_all
from repro_torch.core.twinsearch import mask_from_probe_rows
from repro_torch.core.types import (CFState, OnboardStats, SENTINEL,
                                    as_index)
from repro_torch.distributed.sharding import local_state
from repro_torch.launch.mesh import axis_group
from repro_torch.serving import guard
from repro_torch.sorting import argsort_rows, top_k


def payload_bytes(n_base: int, c: int, branch: str) -> int:
    """Bytes one user's collectives carry on an arena of ``n_base`` rows
    with ``c`` probes, by the row-construction ``branch``: ``base`` (a
    verified base twin), ``new`` (a twin inside the burst) or
    ``fallback`` (the traditional row)."""
    common = 4 * (2 * c * n_base + c) + 16
    return common + {"base": 2 * 4 * n_base, "new": 0,
                     "fallback": 4 * n_base}[branch]


def _host_read(counts: torch.Tensor, best: torch.Tensor,
               eq_new: torch.Tensor, s_max: int) -> list[int]:
    """One copy to the host a user, which picks the row's branch: the
    reduced counters (candidates, found, overflowed), the base twin, and
    whether an earlier user of the burst is a twin and the first such.

    On ``meta`` tensors (a dry run's trace, which reads no data) it returns
    the fallback's values: no base twin, no burst twin, ``s_max``
    candidates.  Each user is then priced at the costliest branch, the
    rank-local mat-vec plus an all-gather of the N_base similarities (the
    reference's ``lax.switch`` compiles all three)."""
    if counts.is_meta:
        return [s_max, 0, 0, -1, 0, 0]
    return torch.cat([counts, best,
                      torch.any(eq_new).reshape(1).to(torch.int32),
                      torch.argmax(eq_new.to(torch.uint8)).reshape(1).to(
                          torch.int32)]).tolist()


def _group_shape(axes, mesh) -> tuple[object, int, int]:
    """(group, rank, world) of the shards: the group ``axes`` of ``mesh``
    name, or the default group (None) without a mesh."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the sharded TwinSearch burst needs an initialised "
            "torch.distributed process group (init_process_group); it does "
            "not fall back to the unsharded burst")
    group = None if mesh is None else axis_group(mesh, axes)
    return group, dist.get_rank(group), dist.get_world_size(group)


def onboard_batch_sharded(state: CFState, R_new: torch.Tensor, probe_idx,
                          *, s_max: int, axes=None, mesh=None,
                          tol: float = 1e-6, maintain: bool = False):
    """The burst of k new users over this rank's rows of an immutable base
    arena.

    ``state`` is this rank's ``local_state``: its rows of the four arrays,
    each list over all N_base arena rows, so N_base = width of
    ``sim_vals`` = rows per rank × world size.  ``R_new`` (k, m) and
    ``probe_idx`` (k, c) are the same on every rank.

    Returns (vals (k, N_base + k) ascending, idx (k, N_base + k) int32,
    stats), the same on every rank; with ``maintain=True`` a fourth element
    (base_vals, base_idx): this rank's (rows, N_base + k) base lists with
    the whole burst merged in."""
    group, rank, world = _group_shape(axes, mesh)
    rows_loc = state.capacity
    N_base = state.sim_vals.shape[1]
    if rows_loc * world != N_base:
        raise ValueError(f"this rank holds {rows_loc} rows of lists over "
                         f"{N_base}; {world} ranks need {N_base} / {world} "
                         "rows each (cut the arena with local_state)")
    offset = rank * rows_loc
    s_loc = min(s_max, rows_loc)
    dev = state.device
    R_new = R_new.to(dev)
    probe_idx = as_index(probe_idx, dev)
    k = R_new.shape[0]
    N_tot = N_base + k
    Rn_new = R_new.float()
    new_norms = torch.sqrt(torch.sum(torch.square(Rn_new), dim=1))
    karange = torch.arange(k, device=dev)

    def fetch(arr: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows ``ids`` of a row-sharded array, on every rank."""
        mine = (ids >= offset) & (ids < offset + rows_loc)
        rows = arr[(ids - offset).clamp(0, rows_loc - 1)]
        none = -0.0 if rows.is_floating_point() else 0
        rows = torch.where(mine[:, None], rows, none)
        dist.all_reduce(rows, group=group)
        return rows

    buf = torch.full((k, N_tot), SENTINEL, dtype=torch.float32, device=dev)
    found, twin, ncand, ovf = [], [], [], []
    for j in range(k):
        r0 = R_new[j]
        probes = probe_idx[j]

        # Probe sims: a dot on the owning rank, summed.
        mine = (probes >= offset) & (probes < offset + rows_loc)
        loc = (probes - offset).clamp(0, rows_loc - 1)
        sims0 = torch.where(mine, cosine_vs_all(state.ratings[loc],
                                                state.norms[loc], r0), -0.0)
        dist.all_reduce(sims0, group=group)

        # Equal-range search and mask intersection (replicated).
        cand = mask_from_probe_rows(fetch(state.sim_vals, probes),
                                    fetch(state.sim_idx, probes), probes,
                                    sims0, tol)

        # Rank-local verification of this rank's candidates.
        mask_loc = cand[offset:offset + rows_loc]
        n_loc = torch.sum(mask_loc)
        _, lidx = top_k(mask_loc.float(), s_loc)
        rows = state.ratings[lidx]
        leq = (torch.all(rows == r0.to(rows.dtype)[None, :], dim=1)
               & mask_loc[lidx])
        found_loc = torch.any(leq)
        # A gather, not an index by a 0-d tensor (which reads it on the
        # host): the first verified candidate, lower index first.
        first = lidx.gather(0, torch.argmax(leq.to(torch.uint8)).reshape(1))
        best = torch.where(found_loc, offset + first, -1).to(torch.int32)
        counts = torch.stack([n_loc, found_loc, n_loc > s_loc]).to(
            torch.int32)
        dist.all_reduce(counts, group=group)
        dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)

        # Twins inside the burst (replicated, no state reads).
        live = karange < j
        eq_new = torch.all(R_new == r0[None, :], dim=1) & live
        n_cand, n_found, n_ovf, twin_b, found_n, twin_n = _host_read(
            counts, best, eq_new, s_max)
        found_b, found_n = n_found > 0, found_n > 0
        bsims = cosine_vs_all(Rn_new, new_norms, r0.float())
        buf[j, N_base:] = torch.where(live, bsims, SENTINEL)

        # Row construction: base copy / burst copy / fallback.
        if found_b:
            ids = torch.tensor([twin_b], device=dev)
            buf[j, :N_base] = unsorted_rows(fetch(state.sim_vals, ids),
                                            fetch(state.sim_idx, ids),
                                            slice(None))[0]
        elif found_n:
            buf[j, :N_base] = buf[twin_n, :N_base]
        else:
            d_loc = cosine_vs_all(state.ratings, state.norms, r0)
            dist.all_gather_into_tensor(buf[j, :N_base], d_loc, group=group)
        found.append(found_b or found_n)
        twin.append(twin_b if found_b else N_base + twin_n)
        ncand.append(n_cand)
        ovf.append(n_ovf > 0)

    vals, idx = argsort_rows(buf)
    stats = OnboardStats(
        found=torch.tensor(found, device=dev),
        twin_idx=torch.tensor(twin, device=dev),
        n_candidates=torch.tensor(ncand, device=dev),
        overflowed=torch.tensor(ovf, device=dev))
    if not maintain:
        return vals, idx.to(torch.int32), stats
    maintained = merge_new_users_into_base(
        state.sim_vals, state.sim_idx, buf[:, offset:offset + rows_loc],
        N_base + karange)
    return vals, idx.to(torch.int32), stats, maintained


def onboard_batch_resilient(state: CFState, R_new: torch.Tensor, probe_idx,
                            *, s_max: int, axes=None, mesh=None,
                            replicas=None, retry=None, tol: float = 1e-6,
                            maintain: bool = False):
    """``onboard_batch_sharded`` behind the serving resilience layer.

    ``state`` is the whole arena, as in the reference.  Before the burst,
    the replicated arena (``distributed.replication.ReplicatedArena``)
    sweeps replica health and heals any poisoned primary rows from
    surviving replicas, in place and bit for bit, so a dead shard's
    garbage never feeds the scan.  Then this rank's rows are cut
    (``local_state``) and the burst runs under the serving
    ``RetryPolicy``.  Returns ``(state, result)``: ``state`` is the
    (possibly healed) arena the burst ran on.

    Raises ``RuntimeError`` if a poisoned row has no surviving replica —
    only a snapshot rollback (the serving layer's job) can help then — or
    if no process group is initialised."""
    _, rank, world = _group_shape(axes, mesh)
    if replicas is not None:
        replicas.sweep()
        fixed, rows = replicas.repair(state)
        if fixed is None:
            raise RuntimeError(
                f"{rows.size} arena rows unrecoverable (all replicas of "
                f"their shard down); roll back to a snapshot")
        state = fixed
    local = local_state(state, rank, world)

    def run():
        out = onboard_batch_sharded(local, R_new, probe_idx, s_max=s_max,
                                    axes=axes, mesh=mesh, tol=tol,
                                    maintain=maintain)
        if local.ratings.is_cuda:
            torch.cuda.synchronize(local.device)
        return out

    result, _retries = guard.call_with_retry(
        run, retry or guard.RetryPolicy())
    return state, result
