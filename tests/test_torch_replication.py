"""Port parity: ``distributed.replication.ReplicatedArena`` and
``distributed.sharding.shard_row_slice`` against the JAX reference's, on
the same state.

Every operation runs on both arenas with the same inputs; returned values,
counters, replica states and every replica's arrays must be equal, and a
repaired primary state equal to the reference's bit for bit.  The port's
``repair`` writes the state in place, so the unrecoverable case must leave
it untouched.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.distributed import replication as jrep
from repro.distributed.sharding import shard_row_slice as jslice
from repro_torch.bridge import state_from_numpy, state_to_numpy
from repro_torch.distributed import (ReplicatedArena, ReplicationConfig,
                                     shard_row_slice)
from repro_torch.distributed import replication as trep
from repro_torch.kernels.verify_rows import ops as health
from tests.conftest import make_ratings

torch.set_num_threads(2)

pytestmark = pytest.mark.faults

FIELDS = ("ratings", "norms", "sim_vals", "sim_idx")


def _states(rng, n=40, m=16, extra=8):
    js = jbuild(jnp.asarray(make_ratings(rng, n=n, m=m)),
                capacity_extra=extra)
    arrays = {k: np.asarray(getattr(js, k)) for k in FIELDS + ("n_active",)}
    return js, state_from_numpy(arrays, "cpu")


def _arenas(js, ts, **cfg):
    return (jrep.ReplicatedArena(js, jrep.ReplicationConfig(**cfg)),
            ReplicatedArena(ts, ReplicationConfig(**cfg)))


def _assert_arenas(ja, ta):
    assert ta.replica_states() == ja.replica_states()
    assert ta.stats() == ja.stats()
    assert (ta.n_rows, ta.n_active, ta.dead_marks) == \
        (ja.n_rows, ja.n_active, ja.dead_marks)
    assert ta._slices == ja._slices
    assert ta.redundancy() == ja.redundancy()
    assert ta.degraded() == ja.degraded()
    for key, jr in ja._replicas.items():
        tr = ta._replicas[key]
        assert tr.progress == jr.progress, key
        assert set(tr.data) == set(jr.data), key
        for f in jr.data:
            if jr.state.value == "rebuilding":
                # Rows past the watermark are uninitialised in both.
                np.testing.assert_array_equal(tr.data[f][:jr.progress],
                                              jr.data[f][:jr.progress])
            else:
                np.testing.assert_array_equal(tr.data[f], jr.data[f],
                                              err_msg=f"{key} {f}")


def _assert_state(js, ts):
    t = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(t[f], np.asarray(getattr(js, f)),
                                      err_msg=f)
    assert int(t["n_active"]) == int(js.n_active)


def _poison(js, ts, rows, field="sim_vals"):
    rows = np.asarray(rows)
    js = js._replace(**{field: getattr(js, field).at[rows].set(jnp.nan)})
    getattr(ts, field)[rows] = float("nan")
    return js


def test_placement_matches_reference():
    for n_shards in range(1, 6):
        for r in range(1, n_shards + 1):
            a = jrep.ReplicationConfig(n_shards=n_shards, r=r)
            b = ReplicationConfig(n_shards=n_shards, r=r)
            assert [b.owners(s) for s in range(n_shards)] == \
                [a.owners(s) for s in range(n_shards)]


@pytest.mark.parametrize("cfg", [dict(n_shards=0), dict(n_shards=3, r=0),
                                 dict(n_shards=3, r=4)])
def test_config_errors_match_reference(cfg):
    with pytest.raises(ValueError) as a:
        jrep.ReplicationConfig(**cfg)
    with pytest.raises(ValueError) as b:
        ReplicationConfig(**cfg)
    assert str(a.value) == str(b.value)


@pytest.mark.parametrize("n_shards,r", [(4, 2), (3, 3), (5, 1), (1, 1)])
def test_construction_and_reads(rng, n_shards, r):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=n_shards, r=r)
    _assert_arenas(ja, ta)
    for row in (0, 11, 23, 47):
        assert ta.shard_of(row) == ja.shard_of(row)
        for f in FIELDS:
            np.testing.assert_array_equal(ta.read_row(f, row),
                                          ja.read_row(f, row))
    # The replicas are copies: writing the primary does not reach them.
    ts.sim_vals[0] = 7.0
    assert ta.read_row("sim_vals", 0)[0] != 7.0


def test_arena_too_small_for_shards(rng):
    js, ts = _states(rng, n=3, m=8, extra=0)
    with pytest.raises(ValueError) as a:
        jrep.ReplicatedArena(js, jrep.ReplicationConfig(n_shards=4, r=2))
    with pytest.raises(ValueError) as b:
        ReplicatedArena(ts, ReplicationConfig(n_shards=4, r=2))
    assert str(a.value) == str(b.value)


def test_apply_rows_mirrors_the_given_rows_only(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=2)
    rows = [2, 13, 47, 13]
    new = np.asarray(js.sim_vals)[rows] + 0.5
    js = js._replace(sim_vals=js.sim_vals.at[np.asarray(rows)].set(new),
                     ratings=js.ratings.at[30].set(9.0))
    ts.sim_vals[rows] = torch.as_tensor(new)
    ts.ratings[30] = 9.0
    js = js._replace(n_active=js.n_active + 3)
    ts = ts._replace(n_active=ts.n_active + 3)
    ja.apply_rows(rows, js)
    ta.apply_rows(rows, ts)
    _assert_arenas(ja, ta)              # row 30 not mirrored in either
    ja.apply_rows([], js)
    ta.apply_rows([], ts)
    _assert_arenas(ja, ta)


def test_kill_node_and_rebuild_with_budget(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=2, rebuild_rows=5)
    assert ta.kill_node(1) == ja.kill_node(1)
    assert ta.kill_node(1) == ja.kill_node(1) == []
    _assert_arenas(ja, ta)
    steps = 0
    while ja.degraded():
        assert ta.step_rebuild() == ja.step_rebuild()
        _assert_arenas(ja, ta)
        steps += 1
    assert not ta.degraded() and steps > 2
    # A write during a rebuild reaches copied rows only; explicit budgets.
    ja.kill_node(3)
    ta.kill_node(3)
    assert ta.step_rebuild(7) == ja.step_rebuild(7)
    new = np.asarray(js.sim_vals)[[36, 44]] + 0.25
    js = js._replace(sim_vals=js.sim_vals.at[np.asarray([36, 44])].set(new))
    ts.sim_vals[[36, 44]] = torch.as_tensor(new)
    ja.apply_rows([36, 44], js)
    ta.apply_rows([36, 44], ts)
    _assert_arenas(ja, ta)
    assert ta.step_rebuild(0) == ja.step_rebuild(0)
    _assert_arenas(ja, ta)


@pytest.mark.parametrize("corrupt", ["nan", "descending", "norm"])
def test_sweep_marks_corrupt_replicas_dead(rng, corrupt):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=2)
    for a in (ja, ta):
        rep = a._replicas[(1, 1)]
        if corrupt == "nan":
            rep.data["sim_vals"][0, 0] = np.nan
        elif corrupt == "descending":
            rep.data["sim_vals"][3, -2:] = rep.data["sim_vals"][3, -2:][::-1]
            rep.data["sim_vals"][3, -1] -= 0.5
        else:
            rep.data["norms"][2] = -1.0
        # Inactive rows (past n_active) are never swept.
        a._replicas[(3, 3)].data["sim_vals"][-1, 0] = np.nan
    assert ta.sweep() == ja.sweep() == [(1, 1)]
    _assert_arenas(ja, ta)


def test_repair_heals_bad_rows_bit_exact(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=2)
    good_j = js
    js = _poison(js, ts, [1, 14, 30])
    js = _poison(js, ts, [20], field="ratings")
    js = _poison(js, ts, [33], field="norms")
    rows = [1, 14, 30]
    vals = np.asarray(js.sim_vals)[9]
    js = js._replace(sim_vals=js.sim_vals.at[9].set(vals[::-1]))
    ts.sim_vals[9] = torch.as_tensor(vals[::-1].copy())
    np.testing.assert_array_equal(ta.bad_rows(ts), ja.bad_rows(js))
    assert list(ta.bad_rows(ts)) == sorted(rows + [9, 20, 33])
    fixed_j, rows_j = ja.repair(js)
    fixed_t, rows_t = ta.repair(ts)
    assert fixed_t is ts
    np.testing.assert_array_equal(rows_t, rows_j)
    _assert_state(fixed_j, fixed_t)
    _assert_state(good_j, fixed_t)
    _assert_arenas(ja, ta)
    # A healthy state repairs nothing.
    fixed_t, rows_t = ta.repair(ts)
    assert fixed_t is ts and rows_t.size == 0 and rows_t.dtype == np.int64


def test_repair_unrecoverable_leaves_state_untouched(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=1)
    # Row 3's shard (0) keeps its replica; row 14's shard (1) loses it.
    js = _poison(js, ts, [3, 14])
    before = state_to_numpy(ts)
    ja.kill_node(1)
    ta.kill_node(1)
    fixed_j, rows_j = ja.repair(js)
    fixed_t, rows_t = ta.repair(ts)
    assert fixed_j is None and fixed_t is None
    np.testing.assert_array_equal(rows_t, rows_j)
    after = state_to_numpy(ts)
    for f in FIELDS:
        np.testing.assert_array_equal(after[f], before[f])
    assert ta.read_row("ratings", 14) is None
    _assert_arenas(ja, ta)


def test_repair_reads_a_rebuilding_replica_below_its_watermark(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=4, r=2, rebuild_rows=4)
    for a in (ja, ta):
        a.kill_node(1)           # shards 0 and 1 lose a copy each
        a.step_rebuild()         # (1, 0) rebuilding: rows 0-3 copied
        a.kill_node(0)           # shard 0's only healthy copy dies
    js = _poison(js, ts, [2])            # below the watermark: healed
    fixed_j, rows_j = ja.repair(js)
    fixed_t, rows_t = ta.repair(ts)
    assert fixed_t is ts and fixed_j is not None
    np.testing.assert_array_equal(rows_t, rows_j)
    _assert_state(fixed_j, fixed_t)
    js = _poison(fixed_j, ts, [8])       # above it: no copy anywhere
    fixed_j, rows_j = ja.repair(js)
    fixed_t, rows_t = ta.repair(ts)
    assert fixed_j is None and fixed_t is None
    np.testing.assert_array_equal(rows_t, rows_j)
    _assert_arenas(ja, ta)


def test_bad_rows_of_an_empty_arena(rng):
    js, ts = _states(rng)
    ja, ta = _arenas(js, ts, n_shards=2, r=2)
    js, ts = js._replace(n_active=jnp.int32(0)), ts._replace(n_active=0)
    a, b = ja.bad_rows(js), ta.bad_rows(ts)
    assert a.shape == b.shape == (0,) and b.dtype == a.dtype


@pytest.mark.parametrize("n_rows", [1, 4, 7, 10, 48, 101, 32_832])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_shard_row_slice_matches_reference(n_rows, n_shards):
    got = [shard_row_slice(n_rows, n_shards, s) for s in range(n_shards)]
    assert got == [jslice(n_rows, n_shards, s) for s in range(n_shards)]
    assert got[-1].stop == n_rows
    for s in (-1, n_shards):
        with pytest.raises(ValueError) as a:
            jslice(n_rows, n_shards, s)
        with pytest.raises(ValueError) as b:
            shard_row_slice(n_rows, n_shards, s)
        assert str(a.value) == str(b.value)


def test_row_rule_matches_reference(rng, monkeypatch):
    vals = np.sort(rng.normal(size=(9, 12)).astype(np.float32), axis=1)
    ratings = rng.normal(size=(9, 5)).astype(np.float32)
    norms = np.abs(rng.normal(size=9)).astype(np.float32)
    vals[1, 4] = np.nan
    vals[2, 3], vals[2, 4] = vals[2, 4], vals[2, 3] - 1
    vals[3, -1] = np.inf
    vals[4, :] = -2.0                   # SENTINEL rows are finite and flat
    ratings[5, 0] = -np.inf
    norms[6] = -0.0                     # -0 >= 0
    norms[7] = np.nan
    norms[8] = -1e-30
    a = jrep._row_ok(ratings, norms, vals)
    for chunk in (2, 4096):             # the primary's sweep, sliced or not
        monkeypatch.setattr(health, "HEALTH_CHUNK_ROWS", chunk)
        b = health.live_rows_ok(torch.as_tensor(vals),
                                torch.as_tensor(ratings),
                                torch.as_tensor(norms), 9)
        np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(trep._row_ok(ratings, norms, vals), a)
    assert list(a) == [True, False, False, False, True, False, True, False,
                       False]


def test_bad_rows_skip_rows_past_n_active(rng):
    js, ts = _states(rng)                # 40 live rows of 48
    ja, ta = _arenas(js, ts, n_shards=4, r=2)
    js = _poison(js, ts, [5, 40, 47])
    np.testing.assert_array_equal(ta.bad_rows(ts), ja.bad_rows(js))
    assert list(ta.bad_rows(ts)) == [5]
    fixed_j, rows_j = ja.repair(js)
    ta.repair(ts)
    _assert_state(fixed_j, ts)           # rows 40 and 47 stay poisoned
    assert torch.isnan(ts.sim_vals[[40, 47]]).all()
