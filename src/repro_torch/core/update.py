"""Incremental similarity maintenance for *existing* users (PyTorch port of
``repro.core.update``).

This is the related-work path (Papagelis et al., ISMIS'05) the paper
contrasts with: when an existing user adds/changes a rating, the cached
dot-products let the affected similarity row refresh in O(n + n log n)
instead of an O(n m) rebuild.  TwinSearch covers the complementary case
(new users with duplicate rows); a production system runs both.

``add_rating`` writes the arena and the cache **in place** (as onboarding
does, see ``core/types.py``): row u's ratings entry, norm and sorted list,
and row and column u of ``dots``.  The (N, N) ``dots`` cache is 4.3 GB at
32,832 rows, so a copy per update is out of the question.  The order of
operations is the reference's, so on integer ratings (where every dot is an
exact integer below 2^24) the result is bit-identical to it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.similarity import _fp32_exact
from repro_torch.core.types import CFState, SENTINEL, active_mask
from repro_torch.sorting import argsort_rows


class SimCache(NamedTuple):
    dots: torch.Tensor      # (N, N) cached R @ R.T
    sq: torch.Tensor        # (N,)   cached ||r_u||^2


def init_cache(ratings: torch.Tensor) -> SimCache:
    """The plain product R @ R.T in full fp32 (TF32 off on the card), and
    the squared row norms."""
    _fp32_exact(ratings)
    Rf = ratings.float()
    return SimCache(dots=Rf @ Rf.T, sq=torch.sum(torch.square(Rf), dim=1))


def refresh_rows(cache: SimCache, ratings: torch.Tensor, lo: int,
                 hi: int) -> SimCache:
    """Bring rows and columns ``[lo, hi)`` of the cache up to date, in
    place: users onboarded since the cache was built (onboarding writes
    their ratings, not the cache).  One (hi - lo, m) x (m, N) product; on
    integer ratings the entries equal a fresh ``init_cache``'s exactly."""
    _fp32_exact(ratings)
    Rf = ratings.float()
    block = Rf[lo:hi] @ Rf.T
    cache.dots[lo:hi] = block
    cache.dots[:, lo:hi] = block.T
    cache.sq[lo:hi] = torch.sum(torch.square(Rf[lo:hi]), dim=1)
    return cache


def add_rating(state: CFState, cache: SimCache, user: int, item: int,
               rating: float) -> tuple[CFState, SimCache]:
    """User ``user`` sets item ``item`` to ``rating`` (0 removes), in place.

    Incremental identities (e = r_new − r_old on coordinate ``item``):
      dots[u, v] += e · R[v, item]      ∀v        — O(n)
      sq[u]      += r_new² − r_old²
    then only row u of the sorted lists re-sorts — O(n log n).  Returns the
    same state and cache objects, written in place.
    """
    u, i = int(user), int(item)
    R = state.ratings
    r_old = R[u, i].clone()
    e = torch.tensor(float(rating), dtype=torch.float32,
                     device=R.device) - r_old

    new_dots_row = cache.dots[u] + e * R[:, i]
    # The u-u self dot also gains e·r_old from the column term; fix exactly:
    self_dot = cache.sq[u] + 2 * r_old * e + e * e
    new_dots_row[u] = self_dot
    cache.dots[u] = new_dots_row
    cache.dots[:, u] = new_dots_row
    cache.sq[u] = self_dot

    R[u, i] = float(rating)
    state.norms[u] = torch.sqrt(self_dot)

    denom = torch.clamp_min(torch.sqrt(self_dot) * torch.clamp_min(
        torch.sqrt(cache.sq), 1e-12), 1e-12)
    sims = new_dots_row / denom
    sims = torch.where(active_mask(state), sims, SENTINEL)
    vals, idx = argsort_rows(sims)
    state.sim_vals[u] = vals
    state.sim_idx[u] = idx.to(torch.int32)
    return state, cache
