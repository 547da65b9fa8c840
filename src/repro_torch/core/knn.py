"""Sorted similarity lists + kNN rating prediction (PyTorch port of
``repro.core.knn``).

Lists are stored ascending, so the "top" of a list is its tail.  Every
sort is stable and every top-k puts the lower index first on ties
(``repro_torch.sorting``), as the JAX reference's ``argsort``/``top_k`` do.
"""
from __future__ import annotations

import torch

from repro_torch.core.similarity import _safe, row_norms, similarity_matrix
from repro_torch.core.types import (CFState, SENTINEL, SENTINEL_GATE,
                                    as_index)
from repro_torch.kernels.knn_score.ops import knn_recommend_topn
from repro_torch.sorting import argsort_rows, top_k
from repro_torch.spans import RECORDER

# Rows per sort call when whole arenas are sorted: torch.sort returns int64
# indices, 8.6 GB for a 32k x 32k arena in one piece.
SORT_CHUNK_ROWS = 4096

# Rows of one tile of ``build_state``'s cosine product, and of its sort
# slices.  At the item arena's 129,490 columns a normalised float64 tile
# is 2.1 GB and a sort slice of 2,048 x 58,541 about 4.3 GB (values,
# int64 indices and the sort's scratch), so beside the 57.7 GB arena the
# build peaks under 64 GB.
TILE_ROWS = 2048
# Rows normalised at a time into a tile (bounds the float32 temporary).
UNIT_CHUNK_ROWS = 256


def sort_rows(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each row ascending (stable); returns (vals, idx) with idx int32."""
    vals, idx = argsort_rows(S)
    return vals, idx.to(torch.int32)


def build_state(R: torch.Tensor, *, capacity_extra: int = 0,
                measure: str = "cosine", hand_over: bool = False
                ) -> CFState:
    """Full similarity build: the traditional O(n^2 m) path, producing the
    sorted lists the system maintains thereafter.  ``capacity_extra``
    preallocates slots for onboarding bursts.  The arena lives on R's
    device.

    With ``hand_over=True``, ``capacity_extra == 0`` and R a contiguous
    float32 tensor, the caller hands R over: it becomes the arena's
    ratings, uncopied, and the arena's writes (``add_rating``) land in
    it.  Otherwise R is copied into the (n + capacity_extra, m) ratings.

    The cosine build is tiled, so nothing of size (n, m) or (n, n) is
    alive beside the arena: row norms a tile at a time (the per-row
    formula of ``row_norms``), then for each tile of ``TILE_ROWS`` rows,
    normalised as ``cosine_matrix`` normalises (the float32 row divided
    by its clamped float32 norm: normalise first, then multiply), its
    products with every later tile normalised alike, written straight
    into both tiles' rows of ``sim_vals`` (the product's transpose is its
    mirror tile), and its rows, complete once the earlier tiles have
    written their mirrors, sorted stably in slices of at most
    min(``TILE_ROWS``, ``SORT_CHUNK_ROWS``) rows.  The products of the
    float32 unit rows are summed in float64 (exact products; TF32 never
    applies) and rounded once to float32: a float32 sum drifts along
    dense rows (up to 1.4e-4 from the exact cosine over 129,490 columns
    on an H100), where this one stays within a few float32 ulps of it.  The other measures build
    their whole (n, n) matrix first.

    Spans: ``knn.build``, with a device span ``knn.tile`` a tile product
    and ``knn.sort`` a sort slice."""
    n, m = R.shape
    N = n + capacity_extra
    dev = R.device
    with RECORDER.span("knn.build"):
        if (hand_over and capacity_extra == 0
                and R.dtype == torch.float32 and R.is_contiguous()):
            ratings = R
        else:
            ratings = torch.zeros((N, m), dtype=torch.float32, device=dev)
            ratings[:n] = R
        norms = torch.zeros(N, dtype=torch.float32, device=dev)
        for r0 in range(0, n, TILE_ROWS):
            norms[r0:r0 + TILE_ROWS] = row_norms(ratings[r0:r0 + TILE_ROWS])
        sim_vals = torch.full((N, N), SENTINEL, dtype=torch.float32,
                              device=dev)
        sim_idx = torch.empty((N, N), dtype=torch.int32, device=dev)
        if measure != "cosine":
            sim_vals[:n, :n] = similarity_matrix(ratings[:n], measure)
        step = min(TILE_ROWS, SORT_CHUNK_ROWS)
        for r0 in range(0, n, TILE_ROWS):
            r1 = min(n, r0 + TILE_ROWS)
            if measure == "cosine":
                _cosine_tiles(ratings, norms, sim_vals, r0, r1, n)
            for s0 in range(r0, r1, step):
                sl = slice(s0, min(r1, s0 + step))
                with RECORDER.span("knn.sort", device=dev.type == "cuda"):
                    sim_vals[sl], sim_idx[sl] = sort_rows(sim_vals[sl])
        # All-SENTINEL padding rows: a stable sort is the identity.
        sim_idx[n:] = torch.arange(N, dtype=torch.int32, device=dev)
    return CFState(ratings=ratings, norms=norms, sim_vals=sim_vals,
                   sim_idx=sim_idx, n_active=n)


def _unit(ratings: torch.Tensor, norms: torch.Tensor, r0: int, r1: int
          ) -> torch.Tensor:
    """Rows [r0, r1) divided by their clamped norms in float32
    (``cosine_matrix``'s normalisation), held in float64 (exactly)."""
    out = torch.empty((r1 - r0, ratings.shape[1]), dtype=torch.float64,
                      device=ratings.device)
    for s0 in range(r0, r1, UNIT_CHUNK_ROWS):
        s1 = min(r1, s0 + UNIT_CHUNK_ROWS)
        out[s0 - r0:s1 - r0] = ratings[s0:s1] / _safe(norms[s0:s1])[:, None]
    return out


def _cosine_tiles(ratings: torch.Tensor, norms: torch.Tensor,
                  sim_vals: torch.Tensor, r0: int, r1: int, n: int) -> None:
    """The products of rows [r0, r1) with rows [r0, n), written into
    ``sim_vals`` at [r0:r1, c0:c1] and mirrored at [c0:c1, r0:r1]."""
    rows = _unit(ratings, norms, r0, r1)
    cuda = ratings.device.type == "cuda"
    for c0 in range(r0, n, TILE_ROWS):
        c1 = min(n, c0 + TILE_ROWS)
        cols = rows if c0 == r0 else _unit(ratings, norms, c0, c1)
        with RECORDER.span("knn.tile", device=cuda):
            out = sim_vals[r0:r1, c0:c1]
            out.copy_(rows @ cols.T)
            if c0 != r0:
                sim_vals[c0:c1, r0:r1] = out.T
        del cols


def top_k_neighbors_batch(state: CFState, users, k: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) users -> ((B, k) sims, (B, k) int64 neighbour ids).

    Slots past the real neighbour count (``k > n_active - 1``) carry
    SENTINEL similarity and neighbour 0, so downstream gathers stay
    in-bounds and weigh them zero.  Entries whose id points at an inactive
    row, the user itself, or a SENTINEL value are masked out."""
    users = as_index(users, state.device)
    vals = state.sim_vals[users]
    idx = state.sim_idx[users].long()
    keep = ((idx != users[:, None]) & (idx < state.n_active)
            & (vals > SENTINEL_GATE))
    ranked = torch.where(keep, vals, SENTINEL)
    kk = min(k, ranked.shape[1])
    top_vals, pos = top_k(ranked, kk)
    nbrs = torch.gather(idx, 1, pos)
    if kk < k:                      # k beyond capacity: pad with dead slots
        B = users.shape[0]
        top_vals = torch.cat([top_vals, torch.full(
            (B, k - kk), SENTINEL, dtype=top_vals.dtype,
            device=top_vals.device)], dim=1)
        nbrs = torch.cat([nbrs, torch.zeros((B, k - kk), dtype=nbrs.dtype,
                                            device=nbrs.device)], dim=1)
    nbrs = torch.where(top_vals > SENTINEL_GATE, nbrs, 0)
    return top_vals, nbrs


def top_k_neighbors(state: CFState, user, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(k,) highest-similarity neighbours of ``user`` (excluding self)."""
    users = as_index(user, state.device)[None]
    sims, nbrs = top_k_neighbors_batch(state, users, k)
    return sims[0], nbrs[0]


def predict_from_neighbors(state: CFState, sims: torch.Tensor,
                           nbrs: torch.Tensor, item) -> torch.Tensor:
    """Weighted average over precomputed neighbour lists: (k,) sims/nbrs
    with a scalar item, or (B, k) with (B,) items.  SENTINEL slots weigh
    zero."""
    item = as_index(item, state.device)
    r = state.ratings[nbrs, item[..., None]]
    w = torch.where((r != 0) & (sims > 0), sims, 0.0)
    denom = torch.sum(torch.abs(w), dim=-1)
    return torch.where(denom > 0, torch.sum(w * r, dim=-1)
                       / torch.clamp_min(denom, 1e-12), 0.0)


def predict(state: CFState, user, item, k: int = 20) -> torch.Tensor:
    """kNN weighted-average rating prediction r̂(u, i) over the top-k
    neighbours of u that rated i."""
    sims, nbrs = top_k_neighbors(state, user, k)
    return predict_from_neighbors(state, sims, nbrs, item)


def predict_batch(state: CFState, users, items, k: int = 20
                  ) -> torch.Tensor:
    """(B,) users x (B,) items -> (B,) predictions."""
    sims, nbrs = top_k_neighbors_batch(state, users, k)
    return predict_from_neighbors(state, sims, nbrs, items)


def recommend_from_neighbors(state: CFState, user, sims: torch.Tensor,
                             nbrs: torch.Tensor, n_rec: int = 10
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Neighbour-weighted item scores (seen items at -inf) and the top
    ``n_rec``, through the knn_score kernel.  ``user`` scalar with (k,)
    lists, or (B,) users with (B, k) lists."""
    users = as_index(user, state.device)
    one = users.dim() == 0
    if one:
        users, sims, nbrs = users[None], sims[None], nbrs[None]
    vals, items = knn_recommend_topn(state.ratings, torch.clamp_min(sims, 0),
                                     nbrs, users, n_rec)
    return (vals[0], items[0]) if one else (vals, items)


def recommend(state: CFState, user, k_neighbors: int = 20, n_rec: int = 10
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-``n_rec`` unseen items for ``user`` by neighbour-weighted score."""
    sims, nbrs = top_k_neighbors(state, user, k_neighbors)
    return recommend_from_neighbors(state, user, sims, nbrs, n_rec)


def recommend_batch(state: CFState, users, k_neighbors: int = 20,
                    n_rec: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """(B,) users -> ((B, n_rec) scores, (B, n_rec) items)."""
    sims, nbrs = top_k_neighbors_batch(state, users, k_neighbors)
    return recommend_from_neighbors(state, users, sims, nbrs, n_rec)
