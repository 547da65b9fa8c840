"""``models.cf.onboard_step`` in item mode (the arena's rows are items)
against the benchmark's plain reference for bursts
(``cfbench/reference_burst.py``): bursts of k identical new items, copies
of a base item and fresh ones, a forced overflow of the candidate bound,
and the spans one burst records."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from cfbench import reference_burst as rb
from repro_torch.bridge import lists_match
from repro_torch.configs.twinsearch_cf import CONFIG
from repro_torch.core import twinsearch as ts
from repro_torch.core.knn import build_state
from repro_torch.models import cf
from repro_torch.spans import RECORDER
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 1e-6
N_ITEMS, N_USERS = 96, 300
CFG = dataclasses.replace(CONFIG, mode="item", sim_tol=1e-6)


def item_arena(seed: int):
    """(F, state): 96 items x 300 users, item-major, and its arena."""
    R = make_ratings(np.random.default_rng(seed), n=N_USERS, m=N_ITEMS)
    F = torch.as_tensor(np.ascontiguousarray(R.T))
    return F, build_state(F.clone(), capacity_extra=0)


def burst(F, kind: str, k: int, seed: int, item: int = 40) -> torch.Tensor:
    if kind == "copy":
        row = F[item]
    else:
        rng = np.random.default_rng(seed)
        row = torch.zeros(N_USERS)
        users = rng.choice(N_USERS, size=20, replace=False)
        row[users] = torch.as_tensor(rng.integers(1, 6, 20),
                                     dtype=torch.float32)
    return row.expand(k, -1).contiguous()


def probes(k: int, seed: int) -> torch.Tensor:
    return ts.make_probes(torch.Generator().manual_seed(seed), k,
                          CFG.c_probes, N_ITEMS)


def judged(F, R_new, out, copied=None):
    vals, idx, stats = out
    (cos,) = rb.base_cosines(F, [R_new], "exact")
    b = {"R_new": R_new, "vals": vals, "idx": idx, "found": stats.found,
         "twin": stats.twin_idx, "overflowed": stats.overflowed}
    return rb.judge_burst(F, b, cos, copied or {}), cos


@pytest.mark.parametrize("kind", ["copy", "fresh"])
@pytest.mark.parametrize("k", [1, 5, 30])
def test_item_burst_matches_the_reference(kind, k):
    F, state = item_arena(11)
    R_new = burst(F, kind, k, seed=k)
    out = cf.onboard_step(state, R_new, probes(k, 100 + k), CFG)
    vals, idx, stats = out
    assert vals.shape == idx.shape == (k, N_ITEMS + k)
    copied = {40: rb.by_id(state.sim_vals[40:41], state.sim_idx[40:41],
                           N_ITEMS)[0]}
    res, cos = judged(F, R_new, out, copied)
    assert res == {"shape": 0, "gap": res["gap"], "unsorted_rows": 0,
                   "id_rows": 0, "flags": 0, "copies": 0, "rows": k}
    assert res["gap"] <= TOL
    # Flags exactly as row equality says, with no overflow to excuse.
    assert not stats.overflowed.any()
    assert torch.equal(stats.found, rb.expected_twins(F, R_new, cos))
    want_v, want_i = rb.expected_lists(F, R_new)
    assert lists_match(want_v.numpy(), want_i.numpy(), vals.numpy(),
                       idx.numpy(), TOL) is None
    if kind == "copy":
        assert torch.equal(stats.twin_idx, torch.full((k,), 40))
    else:
        assert not stats.found[0]
        assert torch.equal(stats.twin_idx[1:], torch.full((k - 1,),
                                                          N_ITEMS))
    # The base is read only.
    _, again = item_arena(11)
    for a, b in zip(state[:4], again[:4]):
        assert torch.equal(a, b)


def test_forced_overflow_falls_back_and_is_excused(monkeypatch):
    """With the candidate bound at 1, a copy of item 60 whose proportional
    double (item 7, identical lists) has a lower id overflows: the bound
    verifies item 7 alone, finds no twin and falls back; later rows twin
    the first."""
    rng = np.random.default_rng(12)
    R = make_ratings(rng, n=N_USERS, m=N_ITEMS)
    R[:, 60] = np.where(R[:, 60] > 0, rng.integers(1, 3, N_USERS), 0)
    R[:, 7] = 2 * R[:, 60]
    F = torch.as_tensor(np.ascontiguousarray(R.T))
    state = build_state(F.clone(), capacity_extra=0)
    monkeypatch.setattr(cf, "set0_cap", lambda *a, **kw: 1)
    k = 5
    R_new = burst(F, "copy", k, seed=0, item=60)
    out = cf.onboard_step(state, R_new, probes(k, 7), CFG)
    _, _, stats = out
    assert stats.overflowed.all() and (stats.n_candidates >= 2).all()
    assert not stats.found[0]
    assert stats.found[1:].all()
    assert torch.equal(stats.twin_idx[1:], torch.full((k - 1,), N_ITEMS))
    res, cos = judged(F, R_new, out)
    assert (res["flags"], res["copies"], res["id_rows"],
            res["unsorted_rows"]) == (0, 0, 0, 0)
    assert res["gap"] <= TOL
    assert rb.expected_twins(F, R_new, cos).all()   # excused, not absent


def test_a_burst_records_its_spans():
    F, state = item_arena(13)
    k = 4
    R_new = torch.cat([burst(F, "copy", 2, 0),
                       burst(F, "fresh", 2, seed=3)])
    RECORDER.clear()
    vals, idx, stats = cf.onboard_step(state, R_new, probes(k, 9), CFG)
    (e,) = RECORDER.entries("cf.onboard_step")
    names = [c[0] for c in e.children]
    for name in ("burst.search", "burst.internal", "burst.block_sims"):
        assert names.count(name) == k
    assert names.count("burst.sort") == 1 and names[-1] == "burst.sort"
    found = int(stats.found.sum())
    assert names.count("burst.copy") == found == 3
    assert names.count("burst.fallback") == k - found == 1
    assert all(c[1] == -1 for c in e.children)
    # Directly, outside a request, the burst records nothing.
    ts.onboard_batch_buffered(state, R_new, probes(k, 9), s_max=8,
                              tol=1e-6)
    assert len(RECORDER.entries()) == 1
