"""Port parity: the serving layer end to end — ``repro_torch`` CFServer on
the CPU against the JAX CFServer, request by request.

Tolerances: statuses, twin flags, user ids, sequence numbers and the
counters of ``ServerStats`` exact; final lists under
``bridge.lists_match`` at 1e-6; predictions within 1e-6; recommendations
under ``bridge.ranked_match`` at 1e-6.  Probes: the port's
``_draw_probes`` seam is patched to return the probes the JAX server draws
from its key chain for the same request.  Both servers get a ladder
monitor on a fixed virtual clock, so compile time in the reference cannot
move the ladder.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax

from repro.serving import CFServer as JServer
from repro.serving import LadderConfig as JLadder
from repro.serving import ServerConfig as JConfig
from repro.serving import SnapshotConfig as JSnap
from repro.testing.faults import poison_state as jpoison_state
from repro.training.elastic import StragglerMonitor as JMonitor
from repro_torch.bridge import lists_match, ranked_match, state_to_numpy
from repro_torch.serving import (CFServer, LadderConfig, LEVEL_SHED,
                                 ServerConfig, SnapshotConfig)
from repro_torch.testing import poison_state
from repro_torch.training.elastic import StragglerMonitor
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 1e-6
COUNTERS = ("onboarded", "twin_hits", "fallbacks", "overflows", "rejected",
            "shed", "errors", "rotations", "snapshots", "rollbacks",
            "degradations", "queries", "query_batches", "query_degraded")


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _pair(R, extra=8, c=4):
    jcfg = JConfig(capacity_extra=extra, c_probes=c,
                   snapshot=JSnap(every=5, check_every=1),
                   ladder=JLadder(monitor=JMonitor(clock=_clock())))
    tcfg = ServerConfig(capacity_extra=extra, c_probes=c,
                        snapshot=SnapshotConfig(every=5, check_every=1),
                        ladder=LadderConfig(
                            monitor=StragglerMonitor(clock=_clock())))
    jsrv = JServer(R, jcfg)
    tsrv = CFServer(R, tcfg, device="cpu")

    def jax_probes():
        # What the JAX server draws next: split its key, randint the sub.
        _, sub = jax.random.split(jsrv._key)
        return torch.tensor(np.asarray(jax.random.randint(
            sub, (tsrv.c,), 0, tsrv.n_base)))

    tsrv._draw_probes = jax_probes
    return jsrv, tsrv


def _onboard_both(jsrv, tsrv, r):
    b = tsrv.onboard_user(r)            # draws from the JAX key before use
    a = jsrv.onboard_user(r)
    assert (a.status, a.twin_found, a.user_id, a.seq, a.rotated) == \
        (b.status, b.twin_found, b.user_id, b.seq, b.rotated)
    return b


def _assert_states(jsrv, tsrv):
    j = {k: np.asarray(getattr(jsrv.state, k))
         for k in ("sim_vals", "sim_idx", "ratings", "n_active")}
    t = state_to_numpy(tsrv.state)
    assert int(t["n_active"]) == int(j["n_active"])
    np.testing.assert_array_equal(t["ratings"], j["ratings"])
    assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"],
                       t["sim_idx"], TOL) is None


def test_server_script_parity(rng):
    R = make_ratings(rng, n=120, m=40)
    fresh = make_ratings(np.random.default_rng(21), n=8, m=40)
    jsrv, tsrv = _pair(R)
    script = [R[3], R[3], R[17], fresh[0], fresh[0], fresh[1], R[40],
              fresh[2],                          # fills the 8 free slots
              R[3], fresh[3], R[77], fresh[1]]   # flood: rotation + more
    res = [_onboard_both(jsrv, tsrv, r) for r in script]
    assert tsrv.stats.rotations == 1 and res[8].rotated
    assert tsrv.stats.twin_hits > 0 and tsrv.stats.fallbacks > 0
    _assert_states(jsrv, tsrv)

    # Reads, with one invalid user id and one invalid item quarantined.
    users = [0, 5, 124, 10_000, 3, 3, 127]
    jrec = jsrv.recommend_batch(users, n=6, k_neighbors=7)
    trec = tsrv.recommend_batch(users, n=6, k_neighbors=7)
    assert trec[3] == jrec[3] == []
    for a, b in zip(jrec, trec):
        if a:
            assert ranked_match([[s for _, s in a]], [[i for i, _ in a]],
                                [[s for _, s in b]], [[i for i, _ in b]],
                                TOL) is None
    items = [1, 2, 3, 4, 99, 6, 7]
    np.testing.assert_allclose(tsrv.predict_batch(users, items, k=7),
                               jsrv.predict_batch(users, items, k=7),
                               atol=TOL)
    assert tsrv.predict(5, 2, k=7) == pytest.approx(
        jsrv.predict(5, 2, k=7), abs=TOL)
    assert tsrv.stats.query_unique == jsrv.stats.query_unique

    # A poisoned arena rolls back to the last good snapshot.
    jpoison_state(jsrv, rows=[2, 17])
    poison_state(tsrv, rows=[2, 17])
    res = _onboard_both(jsrv, tsrv, fresh[4])
    assert res.status == "rolled_back" and res.user_id == -1
    _assert_states(jsrv, tsrv)
    res = _onboard_both(jsrv, tsrv, fresh[4])
    assert res.status == "ok"
    _assert_states(jsrv, tsrv)

    jstats, tstats = jsrv.stats.summary(), tsrv.stats.summary()
    assert {k: tstats[k] for k in COUNTERS} == \
        {k: jstats[k] for k in COUNTERS}
    assert tstats["rollbacks"] == 1 and tstats["rejected"] == 3


def test_rollback_restores_snapshot_clone(rng):
    """The port writes rows in place: rolling back twice must restore the
    same good state both times (the snapshot is never aliased)."""
    R = make_ratings(rng, n=40, m=12)
    srv = CFServer(R, ServerConfig(capacity_extra=4, snapshot=SnapshotConfig(
        every=1000, check_every=1)), device="cpu")
    good = state_to_numpy(srv.state)
    for _ in range(2):
        srv.onboard_user(R[1])
        srv.state.sim_vals[0] = float("nan")
        assert srv.onboard_user(R[2]).status == "rolled_back"
        now = state_to_numpy(srv.state)
        for key in ("sim_vals", "sim_idx", "ratings", "norms"):
            np.testing.assert_array_equal(now[key], good[key])
    assert srv.stats.rollbacks == 2


def test_shed_rung_degrades_reads(rng):
    R = make_ratings(rng, n=40, m=12)
    srv = CFServer(R, ServerConfig(capacity_extra=4), device="cpu")
    full = srv.recommend(3, n=4, k_neighbors=8)
    srv.level = LEVEL_SHED
    srv._shed_until = float("inf")
    assert srv.onboard_user(R[1]).status == "shed"
    assert len(srv.recommend(3, n=4, k_neighbors=8)) == len(full)
    assert srv.stats.query_degraded == 1


def test_malformed_payloads_are_refused(rng):
    R = make_ratings(rng, n=40, m=12)
    srv = CFServer(R, ServerConfig(capacity_extra=4), device="cpu")
    bad = np.full(12, np.nan, np.float32)
    assert srv.onboard_user(bad).status == "rejected"
    assert srv.onboard_user(np.zeros(5)).status == "rejected"
    assert srv.quarantine.summary()["total"] == 2


def test_replicated_server_builds_and_mirrors_every_write(rng):
    """``replication`` is served (it was refused before it was ported):
    the replicas mirror the arena after onboards and add_ratings."""
    from repro_torch.distributed import ReplicationConfig
    R = make_ratings(rng, n=30, m=12)
    srv = CFServer(R, ServerConfig(capacity_extra=6, replication=
                                   ReplicationConfig(n_shards=3, r=2)),
                   device="cpu")
    assert srv.replicas.redundancy() == 2 and not srv.replicas.degraded()
    assert len(srv.stats.replica_reset_ms) == 1        # the construction's
    for i in (1, 1, 7):
        assert srv.onboard_user(R[i]).ok
    assert srv.add_rating(4, 2, 5.0)
    host = state_to_numpy(srv.state)
    for (_, s), rep in srv.replicas._replicas.items():
        sl = srv.replicas._slices[s]
        for f in ("ratings", "norms", "sim_vals", "sim_idx"):
            np.testing.assert_array_equal(rep.data[f], host[f][sl])
    assert srv.stats.summary()["repairs"] == 0
    # Replication adds no reference cycle: the arena goes with the server.
    import gc
    import weakref
    gc.disable()
    try:
        refs = [weakref.ref(x) for x in (srv, srv.state.ratings,
                                         srv.replicas)]
        del srv
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_dropped_server_frees_its_arena_without_the_cycle_collector(
        rng, tmp_path):
    """A server holds GBs on the card: dropping the last reference must
    free it at once, so the server may form no reference cycle (the
    collector runs on object counts, not on device bytes)."""
    import gc
    import weakref
    from repro_torch.serving import RotationConfig, WalConfig
    from repro_torch.serving.guard import RetryPolicy
    R = make_ratings(rng, n=30, m=12)
    gc.disable()
    try:
        srv = CFServer(R, ServerConfig(
            capacity_extra=6,
            snapshot=SnapshotConfig(dir=str(tmp_path / "s"), every=3),
            wal=WalConfig(dir=str(tmp_path / "w")),
            rotation=RotationConfig(budget_rows=4),
            ladder=LadderConfig(retry=RetryPolicy(sleep=lambda s: None))),
            device="cpu")
        for i in range(8):
            assert srv.onboard_user(R[i]).ok
        assert srv.add_rating(1, 2, 3.0)
        refs = [weakref.ref(x) for x in (srv, srv.state.ratings,
                                         srv._snapshot[0].sim_vals)]
        del srv
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
