"""The tiled ``core.knn.build_state`` against the whole-matrix formula it
replaced (``cosine_matrix``, then a stable sort of every row), with tiles
that do not divide the rows, with and without free slots; the hand-over
of R to the arena when asked for, and the copy otherwise; the build's
spans."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.bridge import lists_match
from repro_torch.core import knn
from repro_torch.core.similarity import cosine_matrix, row_norms, \
    similarity_matrix
from repro_torch.core.types import SENTINEL
from repro_torch.spans import RECORDER
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 1e-6


def whole_matrix(R: torch.Tensor, extra: int, measure: str = "cosine"):
    """(vals, idx, norms) as the build made them from the whole matrix."""
    n = R.shape[0]
    N = n + extra
    S = (cosine_matrix(R.float()) if measure == "cosine"
         else similarity_matrix(R.float(), measure))
    full = torch.full((N, N), SENTINEL)
    full[:n, :n] = S
    vals, idx = torch.sort(full, dim=1, stable=True)
    norms = torch.zeros(N)
    norms[:n] = row_norms(R.float())
    return vals, idx.to(torch.int32), norms


@pytest.mark.parametrize("n,tile,extra", [(40, 7, 0), (40, 7, 5),
                                          (33, 11, 3), (12, 64, 0)])
def test_tiled_build_equals_the_whole_matrix(monkeypatch, n, tile, extra):
    rng = np.random.default_rng(n * 100 + tile)
    R = make_ratings(rng, n=n, m=17)
    R[5] = R[2]                                  # a twin: a tie of 1.0
    monkeypatch.setattr(knn, "TILE_ROWS", tile)
    st = knn.build_state(torch.as_tensor(R.copy()), capacity_extra=extra)
    vals, idx, norms = whole_matrix(torch.as_tensor(R), extra)
    assert st.n_active == n and st.capacity == n + extra
    assert torch.equal(st.norms, norms)
    assert torch.equal(st.ratings[:n], torch.as_tensor(R))
    assert not st.ratings[n:].any()
    assert lists_match(vals.numpy(), idx.numpy(), st.sim_vals.numpy(),
                       st.sim_idx.numpy(), TOL) is None
    # Padding rows: all SENTINEL, ids in order.
    assert (st.sim_vals[n:] == SENTINEL).all()
    assert torch.equal(st.sim_idx[n:], torch.arange(n + extra,
                                                    dtype=torch.int32)
                       .expand(extra, -1))


@pytest.mark.parametrize("measure", ["pearson", "adjusted_cosine"])
def test_other_measures_keep_their_formulas(monkeypatch, measure):
    R = make_ratings(np.random.default_rng(3), n=30, m=12)
    monkeypatch.setattr(knn, "TILE_ROWS", 8)
    st = knn.build_state(torch.as_tensor(R.copy()), capacity_extra=2,
                         measure=measure)
    vals, idx, _ = whole_matrix(torch.as_tensor(R), 2, measure)
    assert torch.equal(st.sim_vals, vals) and torch.equal(st.sim_idx, idx)


def test_contiguous_float32_is_handed_over():
    R = torch.as_tensor(make_ratings(np.random.default_rng(4), n=20, m=9))
    st = knn.build_state(R, capacity_extra=0, hand_over=True)
    assert st.ratings is R


@pytest.mark.parametrize("case", ["not_asked", "extra", "float64",
                                  "strided"])
def test_otherwise_the_ratings_are_copied(case):
    """Unless asked, and wherever the hand-over is asked for but the
    arena needs free slots or another layout, R stays the caller's."""
    base = make_ratings(np.random.default_rng(5), n=20, m=9)
    if case == "float64":
        R = torch.as_tensor(base.astype(np.float64))
    elif case == "strided":
        R = torch.as_tensor(np.ascontiguousarray(base.T)).T
    else:
        R = torch.as_tensor(base.copy())
    extra = 3 if case == "extra" else 0
    st = knn.build_state(R, capacity_extra=extra,
                         hand_over=case != "not_asked")
    assert st.ratings.dtype == torch.float32 and st.ratings.is_contiguous()
    assert st.ratings.data_ptr() != R.data_ptr()
    st.ratings[0, 0] = 99.0                      # the caller's R is apart
    assert float(R[0, 0]) == float(base[0, 0])
    assert torch.equal(st.ratings[1:20], torch.as_tensor(base[1:]))


def test_build_spans(monkeypatch):
    monkeypatch.setattr(knn, "TILE_ROWS", 8)
    R = torch.as_tensor(make_ratings(np.random.default_rng(6), n=30, m=10))
    RECORDER.clear()
    with RECORDER.request("test.build"):
        knn.build_state(R, capacity_extra=2)
    (e,) = RECORDER.entries("test.build")
    names = [c[0] for c in e.children]
    assert names[0] == "knn.build"
    tiles = 4                                    # 30 rows in tiles of 8
    assert names.count("knn.tile") == tiles * (tiles + 1) // 2
    assert names.count("knn.sort") == tiles
    assert all(c[1] == 0 for c in e.children[1:])   # all inside knn.build
    knn.build_state(R)                           # outside: records nothing
    assert len(RECORDER.entries()) == 1
