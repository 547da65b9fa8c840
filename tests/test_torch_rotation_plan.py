"""Port parity: the chunked, resumable ``RotationPlan`` and the server's
incremental rotation (``rotation.budget_rows > 0``), ported from
``TestIncrementalRotation`` in ``tests/test_resilience.py``, plus the port's
plan against ``repro``'s on the same JAX-built arena.

Tolerance: none.  A plan is data movement: ``finalize`` must be
bit-identical to ``rotate_arena_frozen`` of the live state, within the port
and against the reference (ratings are integers, so the ``add_rating``
mutations are bit-identical across packages too).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import RotationPlan as JPlan
from repro.core import build_state as jbuild
from repro.core import twinsearch as jts
from repro.core import update as jupd
from repro_torch.bridge import state_from_numpy, state_to_numpy
from repro_torch.core import (RotationPlan, rotate_arena,
                              rotate_arena_frozen, unsorted_rows, update)
from repro_torch.serving import CFServer, RotationConfig, ServerConfig
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _assert_states_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for f in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"field {f}")
    assert int(a["n_active"]) == int(b["n_active"])


def _unsorted_active(state, n_act):
    """(n_act, n_act) unsorted similarity block recovered from the lists."""
    return unsorted_rows(state.sim_vals, state.sim_idx,
                         slice(0, n_act))[:, :n_act].numpy()


def _flooded(rng, *, n=24, m=12, onboards=4):
    """A server whose write region holds ``onboards`` burst rows."""
    R = make_ratings(rng, n=n, m=m)
    srv = CFServer(R, ServerConfig(capacity_extra=8, c_probes=4),
                   device="cpu")
    for i in range(onboards):
        assert srv.onboard_user(R[i]).ok
    return R, srv


def test_frozen_equals_classic_when_boundary_is_live(rng):
    _, srv = _flooded(rng)
    a = rotate_arena(srv.state, n_base=srv.n_base, extra=5)
    b = rotate_arena_frozen(srv.state, n_base=srv.n_base,
                            n_frozen=srv.state.n_active, extra=5)
    _assert_states_equal(a, b)


@pytest.mark.parametrize("chunk", [1, 3, 7, 64])
def test_plan_matches_one_shot(rng, chunk):
    """Chunked precompute + finalize is bit-identical to the one-shot
    frozen rotation, for every chunking."""
    _, srv = _flooded(rng)
    st = srv.state
    ref = rotate_arena_frozen(st, n_base=srv.n_base, n_frozen=st.n_active,
                              extra=5)
    plan = RotationPlan(st, n_base=srv.n_base, extra=5, chunk_rows=chunk)
    steps = 0
    while not plan.done:
        assert plan.step(st, 2) > 0
        steps += 1
    if chunk < srv.n_base:
        assert steps > 1                      # genuinely incremental
    _assert_states_equal(plan.finalize(st), ref)


def test_plan_matches_one_shot_under_mutation(rng):
    """Mid-plan mutations — carried onboards past the frozen boundary, a
    refreshed base row (dirty re-merge), a refreshed *burst* row (stale
    block, restart) — all reconcile: finalize is bit-identical to the
    one-shot frozen rotation of the final live state."""
    R, srv = _flooded(rng)
    n_base = srv.n_base
    plan = RotationPlan(srv.state, n_base=n_base, extra=6, chunk_rows=4)
    n_frozen = plan.n_frozen
    plan.step(srv.state, 8)                   # partial precompute

    assert srv.onboard_user(R[10]).ok         # carried rows
    assert srv.onboard_user(R[11]).ok
    assert srv.add_rating(2, 1, 5.0)          # dirty base row
    plan.note_write(2)
    plan.step(srv.state, 8)
    assert srv.add_rating(n_base + 1, 2, 3.0)  # stale burst block
    plan.note_write(n_base + 1)
    assert plan.restarts == 1

    out = plan.finalize(srv.state)
    ref = rotate_arena_frozen(srv.state, n_base=n_base, n_frozen=n_frozen,
                              extra=6)
    _assert_states_equal(out, ref)
    assert out.n_active == srv.state.n_active
    assert out.capacity == srv.state.n_active + 6


def test_dirty_rows_after_the_sweep_are_re_merged(rng):
    """A base row refreshed after the main sweep passed it is re-merged
    from the live state by the next step (index-tensor rows), not left
    stale."""
    _, srv = _flooded(rng)
    plan = RotationPlan(srv.state, n_base=srv.n_base, extra=4, chunk_rows=2)
    while not plan.done:
        plan.step(srv.state, 100)
    for row in (0, 17, 3):
        assert srv.add_rating(row, 4, 2.0)
        plan.note_write(row)
    assert not plan.done and plan.remaining_rows == 3
    assert plan.step(srv.state, 2) == 2 and plan.remaining_rows == 1
    _assert_states_equal(
        plan.finalize(srv.state),
        rotate_arena_frozen(srv.state, n_base=srv.n_base,
                            n_frozen=plan.n_frozen, extra=4))


def _jnp_state(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


@pytest.mark.parametrize("mutate", [False, True])
def test_plan_matches_reference_plan(rng, mutate):
    """The port's plan and ``repro``'s, driven alike on the same JAX-built
    arena (a burst of twins and fresh rows), finalize to the same bits."""
    R = make_ratings(rng, n=60, m=20)
    burst = np.concatenate([R[[3, 3, 9]], make_ratings(
        np.random.default_rng(4), n=5, m=20)])
    probes = jts.make_probes(jax.random.PRNGKey(2), 8, 4, 60)
    js, _ = jts.onboard_batch(jbuild(jnp.asarray(R), capacity_extra=8),
                              jnp.asarray(burst), probes)
    ts = state_from_numpy(_jnp_state(js), device="cpu")
    jplan = JPlan(js, n_base=60, extra=7, chunk_rows=9)
    tplan = RotationPlan(ts, n_base=60, extra=7, chunk_rows=9)
    jplan.step(js, 20)
    tplan.step(ts, 20)
    if mutate:
        jc, tc = jupd.init_cache(js.ratings), update.init_cache(ts.ratings)
        for u, i, v in ((4, 1, 5.0), (50, 2, 2.0), (63, 0, 4.0)):
            js, jc = jupd.add_rating(js, jc, jnp.int32(u), jnp.int32(i),
                                     jnp.float32(v))
            ts, tc = update.add_rating(ts, tc, u, i, v)
            jplan.note_write(u)
            tplan.note_write(u)
        assert tplan.restarts == jplan.restarts == 1
    assert tplan.remaining_rows == jplan.remaining_rows
    t = state_to_numpy(tplan.finalize(ts))
    j = _jnp_state(jplan.finalize(js))
    for key in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert int(t["n_active"]) == int(j["n_active"]) == 68


def test_incremental_flood_matches_synchronous(rng):
    """The double-flood oracle: a server rotating in budget_rows slices
    and a synchronously-rotating server end a pure onboard flood with
    bit-identical materialised similarity blocks (geometry may differ —
    content must not)."""
    R = make_ratings(rng, n=24, m=12)
    fresh = make_ratings(np.random.default_rng(77), n=6, m=12)
    pool = np.concatenate([R[:4], fresh, R[8:12]], axis=0)

    sync = CFServer(R, ServerConfig(capacity_extra=4, c_probes=4),
                    device="cpu")
    inc = CFServer(R, ServerConfig(
        capacity_extra=4, c_probes=4,
        rotation=RotationConfig(budget_rows=6)), device="cpu")
    for i in range(12):
        assert sync.onboard_user(pool[i % len(pool)]).ok
        assert inc.onboard_user(pool[i % len(pool)]).ok
    assert inc.stats.rotations >= 1

    def materialized(srv):
        st = rotate_arena(srv.state, n_base=srv.n_base, extra=0)
        n = st.n_active
        return _unsorted_active(st, n), st.ratings[:n].numpy()
    u_sync, r_sync = materialized(sync)
    u_inc, r_inc = materialized(inc)
    np.testing.assert_array_equal(r_sync, r_inc)
    np.testing.assert_array_equal(u_sync, u_inc)


def test_step_maintenance_drains_between_bursts(rng):
    """Quiet-period ticks finish the rotation so no onboard ever pays a
    forced drain."""
    R = make_ratings(rng, n=24, m=12)
    srv = CFServer(R, ServerConfig(
        capacity_extra=6, c_probes=4,
        rotation=RotationConfig(budget_rows=4, reserve_slots=3)),
        device="cpu")
    for i in range(4):                         # free slots: 6 -> 2
        assert srv.onboard_user(R[i]).ok
    ticks = 0
    while True:
        prog = srv.step_maintenance()
        ticks += 1
        if not prog["active"]:
            break
        assert ticks < 100
    assert srv.stats.rotations == 1
    assert srv.stats.forced_drains == 0
    assert prog["free_slots"] > 2              # swap re-opened the arena
    assert len(srv.stats.rotation_pause_ms) == 1
    assert srv.stats.summary()["rotation_pause_max_ms"] > 0.0


def test_rotation_ms_still_tracks_rotations(rng):
    R = make_ratings(rng, n=20, m=10)
    srv = CFServer(R, ServerConfig(
        capacity_extra=4, c_probes=4,
        rotation=RotationConfig(budget_rows=4)), device="cpu")
    for i in range(14):
        assert srv.onboard_user(R[i % 20]).ok
    assert srv.stats.rotations >= 1
    assert len(srv.stats.rotation_ms) == srv.stats.rotations
    assert len(srv.stats.rotation_pause_ms) == srv.stats.rotations


def test_add_rating_during_a_plan_restarts_or_dirties_it(rng):
    """The server reports its own add_ratings to its plan: a base row
    dirties it, a frozen burst row restarts it, and the swap still lands
    bit-identical to the frozen rotation of the live state."""
    R = make_ratings(rng, n=24, m=12)
    srv = CFServer(R, ServerConfig(
        capacity_extra=6, c_probes=4,
        rotation=RotationConfig(budget_rows=5, reserve_slots=3)),
        device="cpu")
    for i in range(4):
        assert srv.onboard_user(R[i]).ok
    srv.step_maintenance()
    plan = srv._plan
    assert plan is not None and not plan.done
    assert srv.add_rating(1, 3, 4.0)
    assert srv.add_rating(srv.n_base + 2, 5, 1.0)
    assert plan.restarts == 1
    while not plan.done:
        plan.step(srv.state, 5)
    assert srv.add_rating(0, 2, 2.0)            # dirty after the sweep
    expected = rotate_arena_frozen(srv.state, n_base=plan.n_base,
                                   n_frozen=plan.n_frozen, extra=plan.extra)
    prog = srv.step_maintenance()
    assert not prog["active"] and srv.stats.plan_restarts == 1
    _assert_states_equal(srv.state, expected)
