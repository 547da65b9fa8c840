"""Port parity: the kNN scoring kernel's wrappers against the JAX
reference.

Tolerances: scores agree within 1e-6 with the JAX wrapper (its serial scan
and its Pallas kernel in interpret mode) and with the JAX einsum
``ref.py``; recommended item ids match exactly except where two scores lie
within that tolerance.  The kernel itself is held to its plain version
on the card in ``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.knn_score.ops import knn_recommend_topn as jtopn
from repro.kernels.knn_score.ops import knn_scores as jscores
from repro.kernels.knn_score.ref import knn_scores_ref as jref
from repro_torch.kernels import launch_counts
from repro_torch.kernels.knn_score.ops import knn_recommend_topn, knn_scores

torch.set_num_threads(2)

TOL = 1e-6


def _knn_case(rng, B, k, N, m):
    """Sparse integer ratings (many items no neighbour rated, so scores tie
    at 0), clamped weights with dead (zero-weight) slots."""
    R = (rng.integers(1, 6, (N, m)) * (rng.random((N, m)) < 0.3)
         ).astype(np.float32)
    w = np.maximum(rng.normal(size=(B, k)), 0.0).astype(np.float32)
    nbrs = rng.integers(0, N, (B, k)).astype(np.int32)
    users = rng.integers(0, N, B).astype(np.int32)
    return R, w, nbrs, users


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    fin = np.isfinite(a)
    np.testing.assert_allclose(a[fin], b[fin], atol=TOL, rtol=0)


@pytest.mark.parametrize("B,k,N,m", [(1, 3, 10, 7), (8, 5, 40, 600),
                                     (33, 20, 120, 40), (4, 1, 9, 513)])
def test_knn_scores_parity(B, k, N, m):
    case = _knn_case(np.random.default_rng(B * k + m), B, k, N, m)
    before = launch_counts()["knn_score"]
    out = knn_scores(*map(torch.as_tensor, case)).numpy()
    assert launch_counts()["knn_score"] == before      # plain version ran
    j = list(map(jnp.asarray, case))
    _close(out, jscores(*j, use_pallas=False))
    _close(out, jscores(*j, use_pallas=True, interpret=True))
    _close(out, jref(*j))


def test_out_of_range_ids_clip_like_reference():
    R, w, nbrs, users = _knn_case(np.random.default_rng(0), 4, 3, 12, 9)
    nbrs[0, 0], users[1] = 99, -5
    out = knn_scores(*map(torch.as_tensor, (R, w, nbrs, users))).numpy()
    _close(out, jscores(*map(jnp.asarray, (R, w, nbrs, users)),
                        use_pallas=False))


def test_topn_tie_order_matches_lax_top_k():
    """Unrated items all score exactly 0: the cut must keep the lower item
    index first, as lax.top_k does."""
    R, w, nbrs, users = _knn_case(np.random.default_rng(3), 16, 4, 30, 50)
    R[:, 25:] = 0.0                      # many exact-zero score ties
    tv, ti = knn_recommend_topn(*map(torch.as_tensor, (R, w, nbrs, users)),
                                n_rec=30)
    jv, ji = jtopn(*map(jnp.asarray, (R, w, nbrs, users)), n_rec=30,
                   use_pallas=False)
    _close(tv.numpy(), jv)
    assert np.array_equal(ti.numpy(), np.asarray(ji))

