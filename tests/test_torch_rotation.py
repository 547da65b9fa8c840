"""Port parity: synchronous arena rotation, and onboarding into a rotated
arena (whose lists carry -1 padding ids).

Tolerance: none for rotation — it is data movement, and the port is fed
the same JAX-built state through the bridge, so every field must be
bit-identical.  Onboarding after a rotation: found flags and twin ids
exact, lists under ``bridge.lists_match`` at 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import rotation as jrot
from repro.core import twinsearch as jts
from repro_torch.bridge import lists_match, state_from_numpy, state_to_numpy
from repro_torch.core import rotation, twinsearch as ts
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


def _assert_same(t: dict, j: dict) -> None:
    assert int(t["n_active"]) == int(j["n_active"])
    for key in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)


def _full_arena(rng, n=120, extra=8):
    R = make_ratings(rng, n=n)
    burst = np.concatenate([R[[3, 3, 9]], make_ratings(
        np.random.default_rng(4), n=extra - 3)])
    probes = jts.make_probes(jax.random.PRNGKey(2), extra, 4, n)
    js, _ = jts.onboard_batch(jbuild(jnp.asarray(R), capacity_extra=extra),
                              jnp.asarray(burst), probes)
    return R, js


@pytest.mark.parametrize("headroom", [1.0, 2.5])
def test_rotate_arena_bit_identical(rng, headroom):
    _, js = _full_arena(rng)
    j = _jstate_np(jrot.rotate_arena(js, n_base=120, extra=8,
                                     headroom=headroom))
    t = state_to_numpy(rotation.rotate_arena(
        state_from_numpy(_jstate_np(js), device="cpu"), n_base=120, extra=8,
        headroom=headroom))
    _assert_same(t, j)
    assert (t["sim_idx"] == -1).any()          # rotation padding present


def test_rotate_frozen_with_carried_rows(rng):
    _, js = _full_arena(rng)
    j = _jstate_np(jrot.rotate_arena_frozen(js, n_base=120, n_frozen=124,
                                            extra=5))
    t = state_to_numpy(rotation.rotate_arena_frozen(
        state_from_numpy(_jstate_np(js), device="cpu"), n_base=120,
        n_frozen=124, extra=5))
    _assert_same(t, j)


def test_rotation_chunking_changes_no_bit(rng, monkeypatch):
    _, js = _full_arena(rng)
    whole = state_to_numpy(rotation.rotate_arena(
        state_from_numpy(_jstate_np(js), device="cpu"), n_base=120, extra=8))
    monkeypatch.setattr(rotation, "SORT_CHUNK_ROWS", 13)
    chunked = state_to_numpy(rotation.rotate_arena(
        state_from_numpy(_jstate_np(js), device="cpu"), n_base=120, extra=8))
    _assert_same(chunked, whole)


def test_unsorted_rows_parity(rng):
    _, js = _full_arena(rng)
    rows = np.arange(115, 128)
    j = np.asarray(jrot.unsorted_rows(js.sim_vals, js.sim_idx,
                                      jnp.asarray(rows)))
    st = state_from_numpy(_jstate_np(js), device="cpu")
    np.testing.assert_array_equal(
        rotation.unsorted_rows(st.sim_vals, st.sim_idx,
                               torch.as_tensor(rows)).numpy(), j)


def test_onboard_after_rotation_then_rotate_again(rng):
    """Twins of base users whose lists now carry -1 ids: the copy path's
    scatter must wrap -1 as JAX does.  A second rotation then merges over
    lists that already hold -1 ids."""
    R, js = _full_arena(rng)
    js = jrot.rotate_arena(js, n_base=120, extra=8)
    st = state_from_numpy(_jstate_np(js), device="cpu")
    burst = np.concatenate([R[[3, 5, 5, 60]], make_ratings(
        np.random.default_rng(8), n=4)])
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(6), 8, 4, 128))
    jst, jstats = jts.onboard_batch(js, jnp.asarray(burst),
                                    jnp.asarray(probes))
    tst, tstats = ts.onboard_batch(st, torch.as_tensor(burst), probes)
    np.testing.assert_array_equal(tstats.found.numpy(),
                                  np.asarray(jstats.found))
    np.testing.assert_array_equal(tstats.twin_idx.numpy(),
                                  np.asarray(jstats.twin_idx))
    assert bool(tstats.found[0])
    j, t = _jstate_np(jst), state_to_numpy(tst)
    assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"],
                       t["sim_idx"], 1e-6) is None

    j2 = _jstate_np(jrot.rotate_arena(jst, n_base=128, extra=8))
    t2 = state_to_numpy(rotation.rotate_arena(
        state_from_numpy(j, device="cpu"), n_base=128, extra=8))
    _assert_same(t2, j2)


def test_server_counts_the_rows_its_rotation_reorders(rng):
    """Onboarding writes only the new user's row, so a rotation reorders
    no base row; ``add_rating`` on a base user refreshes its list with real
    values at write-region ids, which that row's merge must partition.  The
    planted arena rotates bit for bit as the reference's."""
    from repro.core.types import CFState as JState
    from repro_torch.core.types import SENTINEL
    from repro_torch.serving import CFServer, ServerConfig

    R = make_ratings(rng, n=40, m=12)
    srv = CFServer(R, ServerConfig(capacity_extra=4, c_probes=4),
                   device="cpu")
    for r in R[:5]:
        assert srv.onboard_user(r).ok
    assert srv.stats.rotations == 1
    assert srv.stats.rotation_reordered_rows == 0
    assert srv.stats.summary()["rotation_reordered_rows"] == 0

    for r in R[5:8]:                     # three rows into the write region
        assert srv.onboard_user(r).ok
    assert srv.add_rating(3, 5, 4.0)
    st = srv.state
    gated_real = (st.sim_idx[:srv.n_base] >= srv.n_base) & (
        st.sim_vals[:srv.n_base] != SENTINEL)
    assert gated_real.any(dim=1).tolist() == [
        r == 3 for r in range(srv.n_base)]
    a = state_to_numpy(st)
    js = jrot.rotate_arena(JState(*(jnp.asarray(a[f]) for f in (
        "ratings", "norms", "sim_vals", "sim_idx", "n_active"))),
        n_base=srv.n_base, extra=4)
    count = torch.zeros(1, dtype=torch.int32)
    t = state_to_numpy(rotation.rotate_arena(
        state_from_numpy(a, device="cpu"), n_base=srv.n_base, extra=4,
        reordered=count))
    _assert_same(t, _jstate_np(js))
    assert int(count) == 1

    assert srv.onboard_user(R[8]).ok     # fills the region: no rotation yet
    assert srv.onboard_user(R[9]).ok     # rotates first
    assert srv.stats.rotations == 2
    assert srv.stats.rotation_reordered_rows == 1
