"""Statistically faithful synthetic rating datasets.

The paper's datasets (MovieLens-100k: 943x1682, 100k ratings, >=20/user;
Douban film: 129,490x58,541, 16.8M ratings) are unavailable offline, so the
pipeline synthesises matrices with the published shapes and the properties
that matter to the algorithm's behaviour:

  * integral 1-5 stars with per-user mean bias + per-item quality bias
    (gives the Gaussian-ish similarity-value distribution the paper's
    Sec 3.2 analysis assumes — validated empirically in the benchmarks);
  * power-law item popularity;
  * per-user rating-count floor (MovieLens guarantees >= 20).

``movielens_100k``/``douban_film`` accept the real files when present
(``u.data`` tab format) and fall back to synthesis otherwise.
"""
from __future__ import annotations

import os

import numpy as np


def synth_ratings(seed: int, n_users: int, n_items: int, n_ratings: int,
                  min_per_user: int = 20, alpha: float = 0.8
                  ) -> np.ndarray:
    """Dense (n_users, n_items) int8 rating matrix, 0 = unrated."""
    rng = np.random.default_rng(seed)
    R = np.zeros((n_users, n_items), np.int8)

    # Power-law item popularity.
    pop = (np.arange(1, n_items + 1) ** -alpha)
    pop /= pop.sum()

    user_bias = rng.normal(0.0, 0.6, n_users)
    item_bias = rng.normal(0.0, 0.5, n_items)

    # Guarantee the per-user floor, then spread the remainder by popularity.
    base = min(min_per_user, max(1, n_ratings // n_users))
    for u in range(n_users):
        items = rng.choice(n_items, size=base, replace=False, p=pop)
        vals = np.clip(np.rint(3.5 + user_bias[u] + item_bias[items]
                               + rng.normal(0, 0.7, base)), 1, 5)
        R[u, items] = vals.astype(np.int8)
    # Top up to the requested count; popularity sampling collides, so loop
    # (bounded) until the deficit closes.
    for _ in range(12):
        deficit = n_ratings - int((R != 0).sum())
        if deficit <= 0:
            break
        us = rng.integers(0, n_users, deficit)
        its = rng.choice(n_items, size=deficit, p=pop)
        vals = np.clip(np.rint(3.5 + user_bias[us] + item_bias[its]
                               + rng.normal(0, 0.7, deficit)), 1, 5)
        R[us, its] = vals.astype(np.int8)
    return R


def movielens_100k(seed: int = 0, path: str | None = None) -> np.ndarray:
    """943 x 1682, 100k ratings (real ``u.data`` if available)."""
    path = path or os.environ.get("ML100K_PATH", "")
    if path and os.path.exists(path):
        R = np.zeros((943, 1682), np.int8)
        data = np.loadtxt(path, dtype=np.int64)
        R[data[:, 0] - 1, data[:, 1] - 1] = data[:, 2].astype(np.int8)
        return R
    return synth_ratings(seed, 943, 1682, 100_000, min_per_user=20)


def douban_film(seed: int = 0, n_users: int = 129_490,
                n_items: int = 58_541, subsample: float = 1.0) -> np.ndarray:
    """Douban-film-scale matrix; ``subsample`` < 1 scales both axes down
    (keeping density) for runs that must fit CPU memory/time."""
    nu = max(64, int(n_users * subsample))
    ni = max(64, int(n_items * subsample))
    nr = int(16_830_839 * (nu / n_users) * (ni / n_items))
    return synth_ratings(seed + 1, nu, ni, max(nr, nu * 5), min_per_user=5)


def plant_twins(R: np.ndarray, k: int, source_user: int | None = None,
                seed: int = 0) -> np.ndarray:
    """The paper's special case / kNN attack: k new users with an identical
    rating list.  Returns the (k, m) new-user block (a copy of an existing
    user's row, or a fresh profile with >= 8 ratings when source is None —
    Calandrino et al.'s attack floor)."""
    rng = np.random.default_rng(seed)
    if source_user is None:
        m = R.shape[1]
        row = np.zeros((m,), R.dtype)
        items = rng.choice(m, size=max(8, int(0.002 * m)), replace=False)
        row[items] = rng.integers(1, 6, items.size).astype(R.dtype)
    else:
        row = R[source_user].copy()
    return np.tile(row, (k, 1))
