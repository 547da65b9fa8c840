"""Port parity: the build and query halves of ``core/knn.py``.

Tolerances: similarities and scores within 1e-6; sorted lists under
``bridge.lists_match`` (ids exact except inside near-ties); recommended
items under ``bridge.ranked_match``.  Query functions are fed the same
JAX-built state through the bridge, so neighbour selection (an exact
top-k with the lower index first on ties) must match exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import knn as jknn
from repro_torch.bridge import (lists_match, ranked_match, state_from_numpy,
                                state_to_numpy)
from repro_torch.core import knn
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 1e-6


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


def _tie_heavy(rng, n=120, m=40):
    R = make_ratings(rng, n=n, m=m)
    R[10:14] = R[3]                    # duplicate users: similarity ties
    R[:, 30:] = 0.0                    # items nobody rated: score ties at 0
    R[R.sum(axis=1) == 0, 0] = 3.0
    return R


@pytest.mark.parametrize("measure", ["cosine", "pearson"])
def test_build_state_parity(rng, measure):
    R = _tie_heavy(rng)
    j = _jstate_np(jbuild(jnp.asarray(R), capacity_extra=8,
                          measure=measure))
    t = state_to_numpy(knn.build_state(torch.as_tensor(R), capacity_extra=8,
                                       measure=measure))
    assert t["n_active"] == j["n_active"] == 120
    np.testing.assert_array_equal(t["ratings"], j["ratings"])
    np.testing.assert_array_equal(t["norms"], j["norms"])
    assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"],
                       t["sim_idx"], TOL) is None


@pytest.mark.parametrize("measure", ["cosine", "pearson"])
@pytest.mark.parametrize("tile,extra", [(7, 0), (7, 8), (11, 0), (11, 8)])
def test_build_state_parity_tiled(rng, monkeypatch, measure, tile, extra):
    """The tiled build against the reference's whole-matrix build, with
    tiles that do not divide the 120 rows: several tiles, their mirrors
    and their edges."""
    R = _tie_heavy(rng)
    monkeypatch.setattr(knn, "TILE_ROWS", tile)
    j = _jstate_np(jbuild(jnp.asarray(R), capacity_extra=extra,
                          measure=measure))
    t = state_to_numpy(knn.build_state(torch.as_tensor(R),
                                       capacity_extra=extra,
                                       measure=measure))
    assert t["n_active"] == j["n_active"] == 120
    np.testing.assert_array_equal(t["ratings"], j["ratings"])
    np.testing.assert_array_equal(t["norms"], j["norms"])
    assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"],
                       t["sim_idx"], TOL) is None


def test_build_state_chunked_sort(rng, monkeypatch):
    """Sorting the arena in row chunks changes no bit."""
    R = _tie_heavy(rng)
    whole = state_to_numpy(knn.build_state(torch.as_tensor(R),
                                           capacity_extra=8))
    monkeypatch.setattr(knn, "SORT_CHUNK_ROWS", 7)
    chunked = state_to_numpy(knn.build_state(torch.as_tensor(R),
                                             capacity_extra=8))
    for key in ("sim_vals", "sim_idx"):
        np.testing.assert_array_equal(chunked[key], whole[key])


@pytest.mark.parametrize("n,extra,k", [(3, 29, 20), (120, 8, 20),
                                       (120, 8, 200)])
def test_top_k_neighbors_batch_parity(rng, n, extra, k):
    """Includes k > n_active - 1 (dead slots clamp to row 0 with SENTINEL
    weight) and k beyond capacity."""
    R = _tie_heavy(rng, n=max(n, 14))[:n]
    js = jbuild(jnp.asarray(R), capacity_extra=extra)
    ts = state_from_numpy(_jstate_np(js), device="cpu")
    users = np.arange(n, dtype=np.int32)
    jv, ji = jax.device_get(jknn.top_k_neighbors_batch(
        js, jnp.asarray(users), k))
    tv, ti = knn.top_k_neighbors_batch(ts, users, k)
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    sv, si = knn.top_k_neighbors(ts, 2, k)
    np.testing.assert_array_equal(sv.numpy(), jv[2])
    np.testing.assert_array_equal(si.numpy(), ji[2])


def test_predict_and_recommend_parity(rng):
    R = _tie_heavy(rng)
    js = jbuild(jnp.asarray(R), capacity_extra=8)
    ts = state_from_numpy(_jstate_np(js), device="cpu")
    users = np.arange(0, 120, 7, dtype=np.int32)
    items = (users * 3 % 40).astype(np.int32)
    jp = np.asarray(jknn.predict_batch(js, jnp.asarray(users),
                                       jnp.asarray(items), 15))
    tp = knn.predict_batch(ts, users, items, 15).numpy()
    np.testing.assert_allclose(tp, jp, atol=TOL, rtol=0)
    assert float(knn.predict(ts, 7, int(items[1]), 15)) == tp[1]

    jv, ji = jax.device_get(jknn.recommend_batch(js, jnp.asarray(users),
                                                 15, 12))
    tv, ti = knn.recommend_batch(ts, users, 15, 12)
    assert ranked_match(jv, ji, tv.numpy(), ti.numpy(), TOL) is None
    sv, si = knn.recommend(ts, 7, 15, 12)
    np.testing.assert_array_equal(sv.numpy(), tv[1].numpy())
    np.testing.assert_array_equal(si.numpy(), ti[1].numpy())
