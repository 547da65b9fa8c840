"""Port parity: the buffered burst onboard (``onboard_batch_buffered``, with
``maintain`` False and True) against the JAX reference, and against the
port's own mutable-arena ``onboard_batch``.

Tolerances: ``found``, ``twin_idx``, ``n_candidates`` and ``overflowed``
exact; sorted values within 2e-5 (the reference's own bound in
``tests/test_maintenance_batch.py``), ids exact except across near-ties
within it (``bridge.lists_match``); every maintained base row lists each
new user exactly once.  Inside the port, the buffered rows equal
``onboard_batch``'s rows bit for bit on integer ratings, and the base
merge of any leading rows, and of a rotated arena's lists, equals one
head-padded ``merge_insert`` bit for bit.  Probes come from JAX.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import twinsearch as jts
from repro_torch.bridge import lists_match, state_from_numpy
from repro_torch.core import (build_state, maintenance, onboard_batch,
                              onboard_batch_buffered, rotate_arena, set0_cap)
from repro_torch.core.types import SENTINEL
from repro_torch.kernels.list_merge.ops import merge_insert
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 2e-5


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


def _burst(R, seed):
    """Base twins (rows 3 and 17, each twice), burst-internal twins (two
    fresh profiles, each three times) and four more fresh users."""
    fresh = make_ratings(np.random.default_rng(seed), n=6, m=R.shape[1])
    return np.stack([R[3], fresh[0], R[17], fresh[0], fresh[1], R[3],
                     fresh[2], fresh[1], fresh[0], fresh[3], R[17],
                     fresh[1], fresh[4], fresh[5]])


def _case(rng, n, m, c, seed):
    R = make_ratings(rng, n=n, m=m)
    R_new = _burst(R, seed)
    js = jbuild(jnp.asarray(R), capacity_extra=0)
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(seed),
                                        R_new.shape[0], c, n))
    return R, R_new, js, probes


@pytest.mark.parametrize("maintain", [False, True])
@pytest.mark.parametrize("n,m,c,seed", [(120, 40, 4, 0), (64, 24, 6, 3),
                                        (200, 60, 8, 5)])
def test_buffered_matches_reference(rng, maintain, n, m, c, seed):
    R, R_new, js, probes = _case(rng, n, m, c, seed)
    s_max = set0_cap(n)
    jout = jts.onboard_batch_buffered(js, jnp.asarray(R_new),
                                      jnp.asarray(probes), s_max=s_max,
                                      maintain=maintain)
    tout = onboard_batch_buffered(state_from_numpy(_jstate_np(js), "cpu"),
                                  torch.as_tensor(R_new), probes,
                                  s_max=s_max, maintain=maintain)
    assert len(tout) == len(jout) == (4 if maintain else 3)
    jv, ji, jst = (jax.device_get(x) for x in jout[:3])
    tv, ti, tst = tout[:3]
    for name in ("found", "twin_idx", "n_candidates", "overflowed"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    k = R_new.shape[0]
    # The burst covers every branch: base twins, burst twins, fresh users.
    found, twin = tst.found.numpy(), tst.twin_idx.numpy()
    assert (found & (twin < n)).any() and (found & (twin >= n)).any()
    assert (~found).any()
    assert tv.shape == ti.shape == (k, n + k) and ti.dtype == torch.int32
    assert lists_match(jv, ji, tv.numpy(), ti.numpy(), TOL) is None
    if maintain:
        (jmv, jmi), (tmv, tmi) = jax.device_get(jout[3]), tout[3]
        assert tmv.shape == tmi.shape == (n, n + k)
        assert lists_match(jmv, jmi, tmv.numpy(), tmi.numpy(), TOL) is None
        ids = tmi.numpy()
        for t in range(k):
            assert ((ids == n + t).sum(axis=1) == 1).all()
        assert (np.diff(tmv.numpy(), axis=1) >= 0).all()


def test_burst_twins_pick_the_first_earlier_twin(rng):
    R, R_new, js, probes = _case(rng, 120, 40, 4, 0)
    _, _, st = onboard_batch_buffered(
        state_from_numpy(_jstate_np(js), "cpu"), torch.as_tensor(R_new),
        probes, s_max=set0_cap(120))
    found, twin = st.found.numpy(), st.twin_idx.numpy()
    for t in range(R_new.shape[0]):
        earlier = [s for s in range(t) if np.array_equal(R_new[s], R_new[t])]
        if found[t] and twin[t] >= 120:
            assert twin[t] == 120 + earlier[0]
        elif not found[t]:
            assert not earlier


@pytest.mark.parametrize("n,m,c", [(120, 40, 4), (80, 30, 6)])
def test_buffered_rows_equal_onboard_batch_rows(rng, n, m, c):
    """The write-buffer path and the mutable-arena path give each burst
    user the same list (integer ratings: every dot is exact)."""
    R = make_ratings(rng, n=n, m=m)
    R_new = _burst(R, 7)
    k = R_new.shape[0]
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(1), k, c, n))
    Rt = torch.as_tensor(R)
    vals, idx, st = onboard_batch_buffered(
        build_state(Rt, capacity_extra=0), torch.as_tensor(R_new), probes,
        s_max=set0_cap(n))
    arena, st2 = onboard_batch(build_state(Rt, capacity_extra=k),
                               torch.as_tensor(R_new), probes,
                               s_max=set0_cap(n))
    for name in ("found", "n_candidates", "overflowed"):
        assert torch.equal(getattr(st, name), getattr(st2, name)), name
    # A twin id is defined where a twin was found.
    assert torch.equal(st.twin_idx[st.found], st2.twin_idx[st.found])
    assert torch.equal(vals, arena.sim_vals[n:])
    assert torch.equal(idx, arena.sim_idx[n:])


def _head_padded_merge(vals, idx, sims, ids):
    """The base merge by its definition: k head (SENTINEL, -1) columns and
    one ``merge_insert`` of the burst over every row."""
    n, k = vals.shape[0], sims.shape[0]
    return merge_insert(
        torch.cat([torch.full((n, k), SENTINEL), vals], dim=1),
        torch.cat([torch.full((n, k), -1, dtype=torch.int32), idx], dim=1),
        sims.T, ids.to(torch.int32))


@pytest.mark.parametrize("n_rows", [1, 7, 32, 119])
def test_chunked_merge_equals_unchunked(rng, n_rows):
    """The base merge of the first ``n_rows`` rows alone equals those rows
    of one head-padded ``merge_insert`` over all 120, bit for bit (the
    merge is row-local)."""
    R = make_ratings(rng, n=120, m=40)
    st = build_state(torch.as_tensor(R), capacity_extra=0)
    k = 9
    sims = torch.as_tensor(np.random.default_rng(n_rows).uniform(
        -1, 1, (k, 120)).astype(np.float32))
    sims[3] = sims[1]                              # ties keep burst order
    ids = 120 + torch.arange(k)
    whole = _head_padded_merge(st.sim_vals, st.sim_idx, sims, ids)
    rows = slice(0, n_rows)
    part = maintenance.merge_new_users_into_base(
        st.sim_vals[rows], st.sim_idx[rows], sims[:, rows], ids)
    assert torch.equal(whole[0][rows], part[0])
    assert torch.equal(whole[1][rows], part[1])


def test_base_merge_of_rotated_lists_gates_nothing(rng):
    """A rotated arena's lists hold id -1 at their SENTINEL head slots (and
    the write region's ids): ``n_base`` = L gates none of them, so the
    base merge equals the head-padded ``merge_insert`` bit for bit."""
    R = make_ratings(rng, n=120, m=40)
    st, _ = onboard_batch(build_state(torch.as_tensor(R[:112]),
                                      capacity_extra=8),
                          torch.as_tensor(R[112:]),
                          torch.randint(0, 112, (8, 4),
                                        generator=torch.Generator()
                                        .manual_seed(5)),
                          s_max=set0_cap(112))
    st = rotate_arena(st, n_base=112, extra=8)
    vals, idx = st.sim_vals, st.sim_idx
    N = vals.shape[0]
    assert N == 128 and bool((idx[:st.n_active] == -1).any())
    k = 7
    sims = torch.as_tensor(np.random.default_rng(7).uniform(
        -1, 1, (k, N)).astype(np.float32))
    sims[4] = sims[2]
    sims[5, :10] = SENTINEL                        # ties with the heads
    ids = N + torch.arange(k)
    want = _head_padded_merge(vals, idx, sims, ids)
    got = maintenance.merge_new_users_into_base(vals, idx, sims, ids)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_base_state_is_not_written(rng):
    R, R_new, js, probes = _case(rng, 64, 24, 6, 3)
    st = state_from_numpy(_jstate_np(js), "cpu")
    before = [t.clone() for t in st[:4]]
    onboard_batch_buffered(st, torch.as_tensor(R_new), probes,
                           s_max=set0_cap(64), maintain=True)
    for a, b in zip(before, st[:4]):
        assert torch.equal(a, b)
