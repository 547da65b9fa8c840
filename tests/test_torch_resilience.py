"""Port parity: the fault-injection scenarios of ``tests/test_resilience.py``
on the port's ``CFServer`` and its own fault harness
(``repro_torch.testing``): replication (replica kill, failover reads,
re-replication, the ``degraded`` rung), snapshot rollback and shard loss,
guard quarantine, the degradation ladder under scripted latency, retry,
and a capacity flood.

Each scenario keeps the reference test's asserts on the port, and runs
the JAX server through the same script with the reference's harness:
statuses, twin flags, user ids, rungs, ``ServerStats`` counters and ladder
levels must be equal, the final lists within 1e-6 (``bridge.lists_match``),
ratings exact.  The port's probes are the JAX server's (its
``_draw_probes`` is patched to the JAX key chain).  Servers whose
reference test uses the default monitor get one on a ticking virtual
clock instead, so compile time in the reference cannot move the ladder.
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import jax

from repro.distributed import ReplicationConfig as JRepConfig
from repro.serving import CFServer as JServer
from repro.serving import ServerConfig as JConfig
from repro.serving.guard import RetryPolicy as JRetry
from repro.testing import faults as jfaults
from repro.training.elastic import StragglerMonitor as JMonitor
from repro_torch.bridge import lists_match, ranked_match, state_to_numpy
from repro_torch.distributed import ReplicaState, ReplicationConfig
from repro_torch.kernels.verify_rows.ops import arena_healthy
from repro_torch.serving import (CFServer, LadderConfig, LEVEL_DEGRADED,
                                 LEVEL_SHED, LEVEL_TRADITIONAL,
                                 LEVEL_TWINSEARCH, ServerConfig)
from repro_torch.serving.guard import RetryPolicy
from repro_torch.testing import (FakeClock, Flaky, MalformedRequests,
                                 capacity_flood, forbid_similarity_kernels,
                                 inject_latency, kill_replica, poison_state)
from repro_torch.training import checkpoint
from repro_torch.training.elastic import StragglerMonitor
from tests.conftest import make_ratings

torch.set_num_threads(2)

pytestmark = pytest.mark.faults

TOL = 1e-6
COUNTERS = ("onboarded", "twin_hits", "fallbacks", "overflows", "rejected",
            "shed", "retries", "errors", "rotations", "snapshots",
            "rollbacks", "repairs", "degradations", "recoveries", "queries",
            "query_batches", "query_degraded")
FIELDS = ("ratings", "norms", "sim_vals", "sim_idx")


def _ticking():
    ticks = itertools.count()
    return lambda: float(next(ticks))


class Pair:
    """The JAX server and the port's on the same ratings and settings,
    driven request by request (the port first: its probes are the ones
    the JAX server is about to draw)."""

    def __init__(self, R, *, monitor=None, retry=None, replication=None,
                 snapshot_dirs=None, **kw):
        jkw, tkw = dict(kw), dict(kw)
        if snapshot_dirs is not None:
            jkw["snapshot_dir"], tkw["snapshot_dir"] = snapshot_dirs
        if monitor is None:
            jkw["monitor"] = JMonitor(clock=_ticking())
            tkw["monitor"] = StragglerMonitor(clock=_ticking())
        else:
            jkw["monitor"], tkw["monitor"] = monitor
        if retry is not None:
            jkw["retry"] = JRetry(**retry, sleep=lambda s: None)
            tkw["retry"] = RetryPolicy(**retry, sleep=lambda s: None)
        if replication is not None:
            jkw["replication"] = JRepConfig(**replication)
            tkw["replication"] = ReplicationConfig(**replication)
        self.j = JServer(R, JConfig.from_kwargs(**jkw))
        self.t = CFServer(R, ServerConfig.from_kwargs(**tkw), device="cpu")
        jsrv, tsrv = self.j, self.t

        def jax_probes():
            _, sub = jax.random.split(jsrv._key)
            return torch.tensor(np.asarray(jax.random.randint(
                sub, (tsrv.c,), 0, tsrv.n_base)))

        self.t._draw_probes = jax_probes

    def onboard(self, r):
        b = self.t.onboard_user(r)
        a = self.j.onboard_user(r)
        assert (a.status, a.twin_found, a.user_id, a.seq, a.rotated,
                a.rung, a.reason) == (b.status, b.twin_found, b.user_id,
                                      b.seq, b.rotated, b.rung, b.reason)
        assert (a.retry_after_s is None) == (b.retry_after_s is None)
        return b

    def recommend(self, user, n=5):
        b = self.t.recommend(user, n=n)
        a = self.j.recommend(user, n=n)
        assert len(a) == len(b)
        if a:
            assert ranked_match([[s for _, s in a]], [[i for i, _ in a]],
                                [[s for _, s in b]], [[i for i, _ in b]],
                                TOL) is None
        return b

    def predict(self, user, item):
        b = self.t.predict(user, item)
        assert b == pytest.approx(self.j.predict(user, item), abs=TOL)
        return b

    def add_rating(self, user, item, value):
        b = self.t.add_rating(user, item, value)
        assert self.j.add_rating(user, item, value) == b
        return b

    def check(self):
        """Counters, ladder level, replica health and the live state."""
        js, ts = self.j.stats.summary(), self.t.stats.summary()
        assert {k: ts[k] for k in COUNTERS} == {k: js[k] for k in COUNTERS}
        assert self.t.level == self.j.level
        assert self.t.n_base == self.j.n_base
        if self.j.replicas is not None:
            assert self.t.replicas.replica_states() == \
                self.j.replicas.replica_states()
            assert self.t.replicas.stats() == self.j.replicas.stats()
        t = state_to_numpy(self.t.state)
        n = int(t["n_active"])
        assert n == int(self.j.state.n_active)
        assert t["sim_vals"].shape == self.j.state.sim_vals.shape
        j = {k: np.asarray(getattr(self.j.state, k))[:n] for k in FIELDS}
        np.testing.assert_array_equal(t["ratings"][:n], j["ratings"])
        np.testing.assert_allclose(t["norms"][:n], j["norms"], atol=TOL)
        assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"][:n],
                           t["sim_idx"][:n], TOL) is None


def _live(srv) -> dict:
    n = srv.state.n_active
    return {f: getattr(srv.state, f)[:n].clone() for f in FIELDS}


def _healthy(srv) -> bool:
    st = srv.state
    return bool(arena_healthy(st.sim_vals, st.ratings, st.norms,
                              st.n_active))


# ---------------------------------------------------------------------------
# Replication: replica kill, failover reads, re-replication
# ---------------------------------------------------------------------------

class TestReplication:
    def test_placement_chained_declustering(self):
        cfg = ReplicationConfig(n_shards=4, r=2)
        assert cfg.owners(0) == (0, 1)
        assert cfg.owners(3) == (3, 0)
        for node in range(4):
            for s in range(4):
                assert any(n != node for n in cfg.owners(s))

    @pytest.mark.parametrize("node", [0, 1, 2, 3])
    def test_any_single_replica_down_stays_available(self, rng, node):
        """With any single node down (its replicas gone and its primary
        shard rows garbage) the server answers identically, heals from
        survivors bit for bit, and restores r-way redundancy, without a
        single similarity computation."""
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, c_probes=4,
                 replication=dict(n_shards=4, r=2))
        srv = p.t
        for i in range(4):
            p.onboard(R[i])
        users = [1, 11, 21, 31, 41]
        before = {u: p.recommend(u) for u in users}
        good = _live(srv)

        jfaults.forbid_similarity_kernels(p.j)
        forbid_similarity_kernels(srv)
        lost = kill_replica(srv, node)
        np.testing.assert_array_equal(lost, jfaults.kill_replica(p.j, node))
        assert srv.replicas.degraded()

        after = {u: p.recommend(u) for u in users}
        assert after == before
        assert srv.stats.repairs >= 1
        assert srv.stats.rollbacks == 0
        assert srv.replicas.redundancy() == 2
        assert srv.replicas.rebuilt_rows > 0
        for f, t in _live(srv).items():
            assert torch.equal(t, good[f]), f
        p.check()

    def test_degraded_rung_pins_ladder_until_redundancy_restored(self, rng):
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, c_probes=4, recover_after=1,
                 replication=dict(n_shards=4, r=2, rebuild_rows=5))
        srv = p.t
        p.onboard(R[0])
        assert srv.level == LEVEL_TWINSEARCH
        p.j.replicas.kill_node(2)
        srv.replicas.kill_node(2)               # replicas only; primary ok
        info = p.onboard(R[1])
        assert info.status == "ok"
        assert srv.level == LEVEL_DEGRADED
        assert info.rung == "degraded"
        assert not info.twin_found              # degraded = traditional path

        seen_degraded = 0
        for _ in range(8):
            p.recommend(1, n=3)
            assert srv.level == p.j.level
            if srv.replicas.degraded():
                seen_degraded += 1
        assert seen_degraded >= 2
        assert srv.replicas.redundancy() == 2
        assert srv.level == LEVEL_TRADITIONAL
        p.onboard(R[2])
        assert srv.level == LEVEL_TWINSEARCH
        p.check()

    def test_unrecoverable_rows_fall_back_to_rollback(self, rng):
        """r=1: losing the only replica of a shard leaves its poison
        unrecoverable; rollback is the backstop and the server stays
        pinned degraded but available."""
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, c_probes=4, check_every=1,
                 replication=dict(n_shards=4, r=1))
        srv = p.t
        p.onboard(R[0])
        jfaults.kill_replica(p.j, 2)
        kill_replica(srv, 2)
        info = p.onboard(R[1])
        assert info.status == "rolled_back"
        assert srv.stats.rollbacks == 1
        assert srv.level == LEVEL_DEGRADED
        info = p.onboard(R[1])
        assert info.status == "ok"
        p.check()

    def test_rebuilding_replica_absorbs_writes(self, rng):
        """Writes landing mid-rebuild are not lost: rows already copied
        take them directly, later rows pick them up from the source."""
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, c_probes=4,
                 replication=dict(n_shards=4, r=2, rebuild_rows=3))
        srv = p.t
        p.j.replicas.kill_node(1)
        srv.replicas.kill_node(1)
        while srv.replicas.degraded():
            p.add_rating(int(rng.integers(0, 40)), int(rng.integers(0, 16)),
                         4.0)
        assert not p.j.replicas.degraded()
        host = state_to_numpy(srv.state)
        for (n, s), rep in srv.replicas._replicas.items():
            assert rep.state is ReplicaState.HEALTHY
            sl = srv.replicas._slices[s]
            for f in FIELDS:
                np.testing.assert_array_equal(
                    rep.data[f], host[f][sl],
                    err_msg=f"replica ({n},{s}) field {f}")
        p.check()

    def test_replica_sweep_catches_silent_corruption(self, rng):
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, check_every=2,
                 replication=dict(n_shards=4, r=2))
        srv = p.t
        for a in (p.j, srv):
            a.replicas._replicas[(1, 1)].data["sim_vals"][0, 0] = np.nan
        for i in range(3):
            p.onboard(R[i])
        assert srv.replicas._replicas[(1, 1)].state is not \
            ReplicaState.HEALTHY or srv.replicas.rebuilt_rows > 0
        assert srv.replicas.dead_marks >= 1
        assert srv.replicas.dead_marks == p.j.replicas.dead_marks
        p.check()

    def test_rotation_resets_replicas_to_new_geometry(self, rng):
        R = make_ratings(rng, n=20, m=10)
        p = Pair(R, capacity_extra=4, c_probes=4,
                 replication=dict(n_shards=4, r=2))
        srv = p.t
        for i in range(6):
            p.onboard(R[i])
        assert srv.stats.rotations >= 1
        assert srv.replicas.n_rows == srv.state.capacity
        # One timed reset at construction and one after each rotation.
        assert len(srv.stats.replica_reset_ms) == 1 + srv.stats.rotations
        jfaults.kill_replica(p.j, 0)
        kill_replica(srv, 0)
        assert p.recommend(3, n=3)
        assert srv.stats.rollbacks == 0
        p.check()

    def test_add_rating_and_maintenance_are_forbidden_too(self, rng):
        """Every similarity-computing seam raises once forbidden: the
        traditional onboard, the dots cache's build and refresh, and
        ``add_rating`` (each failure is the server's own no-raise
        handling, or the harness's AssertionError)."""
        R = make_ratings(rng, n=30, m=12)
        srv = CFServer(R, ServerConfig(
            capacity_extra=4, replication=ReplicationConfig(n_shards=2),
            ladder=_one_attempt_ladder()), device="cpu")
        assert srv.add_rating(1, 2, 3.0)
        assert srv.onboard_user(R[4]).ok        # the cache now lags a row
        forbid_similarity_kernels(srv)
        for seam in ("_onboard", "_onboard_trad", "_init_cache", "_add",
                     "_refresh_cache"):
            with pytest.raises(AssertionError, match="similarity kernel"):
                getattr(srv, seam)()
        with pytest.raises(AssertionError, match="similarity kernel"):
            srv.add_rating(1, 3, 4.0)
        assert srv.onboard_user(R[5]).status == "error"


def _one_attempt_ladder():
    """A virtual-clock monitor and a retry policy without retries."""
    return LadderConfig(monitor=StragglerMonitor(clock=_ticking()),
                        retry=RetryPolicy(max_attempts=1,
                                          sleep=lambda s: None))


# ---------------------------------------------------------------------------
# Snapshot / rollback (state poisoning, simulated shard loss)
# ---------------------------------------------------------------------------

class TestSnapshotRollback:
    def test_poisoned_lists_roll_back(self, rng, tmp_path):
        R = make_ratings(rng, n=30, m=12)
        p = Pair(R, capacity_extra=8, snapshot_every=3, check_every=1,
                 snapshot_dirs=(str(tmp_path / "j"), str(tmp_path / "t")))
        srv = p.t
        for i in range(4):
            p.onboard(R[i])
        good_n = srv.state.n_active
        assert checkpoint.all_steps(str(tmp_path / "t"))

        np.testing.assert_array_equal(
            poison_state(srv, rows=[2, 17]),
            jfaults.poison_state(p.j, rows=[2, 17]))
        info = p.onboard(R[5])
        assert info.user_id == -1 and info.status == "rolled_back"
        assert srv.stats.rollbacks == 1
        assert srv.state.n_active <= good_n
        assert _healthy(srv)
        info = p.onboard(R[5])
        assert info.status == "ok"
        assert len(p.recommend(srv.state.n_active - 1, n=3)) == 3
        p.check()

    def test_simulated_shard_loss_rolls_back(self, rng):
        R = make_ratings(rng, n=32, m=12)
        p = Pair(R, capacity_extra=8, snapshot_every=2, check_every=1)
        srv = p.t
        for i in range(3):
            p.onboard(R[i])
        lost = poison_state(srv, shard=2, n_shards=4, field="ratings")
        np.testing.assert_array_equal(lost, jfaults.poison_state(
            p.j, shard=2, n_shards=4, field="ratings"))
        assert lost.shape[0] == 10                 # 40-row arena / 4
        assert torch.isnan(srv.state.ratings[20:30]).all()
        info = p.onboard(R[7])
        assert info.user_id == -1 and info.status == "rolled_back"
        assert srv.stats.rollbacks == 1
        info = p.onboard(R[7])
        assert info.status == "ok"
        p.check()

    def test_rollback_across_rotation_restores_geometry(self, rng):
        R = make_ratings(rng, n=20, m=10)
        p = Pair(R, capacity_extra=2, snapshot_every=10_000, check_every=1)
        srv = p.t
        cap0, nb0 = srv.state.capacity, srv.n_base
        for i in range(5):
            p.onboard(R[i])
        assert srv.stats.rotations >= 1
        assert srv.state.capacity > cap0
        poison_state(srv, rows=[1])
        jfaults.poison_state(p.j, rows=[1])
        info = p.onboard(R[6])
        assert info.status == "rolled_back"
        assert srv.state.capacity == cap0 and srv.n_base == nb0
        info = p.onboard(R[6])
        assert info.status == "ok"
        p.check()


# ---------------------------------------------------------------------------
# Guard + quarantine
# ---------------------------------------------------------------------------

class TestGuardQuarantine:
    def test_malformed_onboards_never_raise(self, rng):
        R = make_ratings(rng, n=40, m=16)
        p = Pair(R, capacity_extra=8, c_probes=4)
        srv = p.t
        mal, jmal = MalformedRequests(16, seed=1), \
            jfaults.MalformedRequests(16, seed=1)
        for (name, bad), (_, jbad) in zip(mal.everything(),
                                          jmal.everything()):
            np.testing.assert_array_equal(bad, jbad)
            info = p.onboard(bad)
            assert info.user_id == -1 and info.status == "rejected", name
        assert srv.stats.rejected == 7
        assert srv.quarantine.total == 7
        assert set(srv.quarantine.counts) == {
            "non_finite", "shape", "dtype", "range", "empty"}
        assert srv.quarantine.counts == p.j.quarantine.counts
        assert _healthy(srv)
        info = p.onboard(R[3])
        assert info.user_id == 40 and info.status == "ok"
        p.check()

    def test_query_and_update_guards(self, rng):
        R = make_ratings(rng, n=30, m=12)
        p = Pair(R, capacity_extra=4)
        srv = p.t
        assert p.recommend(-1) == []
        assert p.recommend(10_000) == []
        assert p.predict(5, 10_000) == 0.0
        assert not p.add_rating(5, 3, float("nan"))
        assert not p.add_rating(5, 3, 99.0)
        assert not p.add_rating("x", 3, 4.0)
        assert srv.stats.rejected == 6
        assert p.add_rating(5, 3, 4.0)
        assert float(srv.state.ratings[5, 3]) == 4.0
        p.check()

    def test_quarantine_ring_is_bounded(self, rng):
        R = make_ratings(rng, n=20, m=10)
        p = Pair(R, capacity_extra=2, quarantine_capacity=5)
        for _ in range(20):
            p.onboard(np.full(10, np.nan, np.float32))
        assert len(p.t.quarantine.records) == 5
        assert p.t.quarantine.total == 20
        p.check()


# ---------------------------------------------------------------------------
# Degradation ladder (latency spikes, virtual time)
# ---------------------------------------------------------------------------

class TestDegradationLadder:
    @staticmethod
    def _pair(R, hang_timeout_s=1000.0, capacity_extra=64, **kw):
        clocks = FakeClock(), jfaults.FakeClock()
        monitors = tuple(
            M(window=20, straggler_ratio=2.0, hang_timeout_s=hang_timeout_s,
              consecutive_to_shrink=2, clock=c)
            for M, c in ((JMonitor, clocks[1]), (StragglerMonitor,
                                                  clocks[0])))
        p = Pair(R, monitor=monitors, capacity_extra=capacity_extra,
                 c_probes=4, snapshot_every=10_000, check_every=10_000, **kw)
        return p, clocks

    @staticmethod
    def _advance(clocks, dt):
        for c in clocks:
            c.advance(dt)

    def test_spikes_step_down_ladder_then_recover(self, rng):
        R = make_ratings(rng, n=40, m=16)
        p, clocks = self._pair(R, recover_after=5, shed_cooldown_s=10.0)
        srv = p.t
        schedule = [0.1] * 12 + [1.0] * 4 + [0.1] * 30
        inject_latency(srv, clocks[0], schedule)
        jfaults.inject_latency(p.j, clocks[1], schedule)
        for i in range(16):
            info = p.onboard(R[i % 40])
            assert info.status == "ok"
            assert srv.level == p.j.level
        # two straggler verdicts: twinsearch -> traditional -> shed (the
        # latency walk skips the replica-owned ``degraded`` rung)
        assert srv.stats.degradations == 2
        assert srv.level == LEVEL_SHED

        info = p.onboard(R[0])
        assert info.user_id == -1 and info.status == "shed"
        assert info.retry_after_s > 0
        assert srv.stats.shed == 1

        self._advance(clocks, 11.0)
        info = p.onboard(R[0])
        assert info.status == "ok" and srv.level == LEVEL_TRADITIONAL
        for i in range(6):
            p.onboard(R[i])
            assert srv.level == p.j.level
        assert srv.level == LEVEL_TWINSEARCH
        assert srv.stats.recoveries == 2
        p.check()

    def test_hang_sheds_immediately(self, rng):
        R = make_ratings(rng, n=40, m=16)
        p, clocks = self._pair(R, hang_timeout_s=5.0, capacity_extra=16)
        srv = p.t
        inject_latency(srv, clocks[0], [0.1] * 10 + [60.0])
        jfaults.inject_latency(p.j, clocks[1], [0.1] * 10 + [60.0])
        for i in range(10):
            p.onboard(R[i])
        assert srv.level == LEVEL_TWINSEARCH
        info = p.onboard(R[10])                   # hang-scale latency
        assert info.status == "ok"                # the call did finish...
        assert srv.level == LEVEL_SHED            # ...but ABORT -> shed
        p.check()


# ---------------------------------------------------------------------------
# Retry / transient executor faults
# ---------------------------------------------------------------------------

class TestRetry:
    def test_transient_fault_retries_to_success(self, rng):
        R = make_ratings(rng, n=30, m=12)
        p = Pair(R, capacity_extra=4, retry=dict(
            max_attempts=4, base_delay_s=1e-4, deadline_s=10.0))
        srv = p.t
        srv._onboard = Flaky(srv._onboard, fail_times=2)
        p.j._onboard = jfaults.Flaky(p.j._onboard, fail_times=2)
        info = p.onboard(R[0])
        assert info.user_id == 30 and info.status == "ok"
        assert srv.stats.retries == 2
        p.check()

    def test_permanent_fault_is_quarantined_not_raised(self, rng):
        R = make_ratings(rng, n=30, m=12)
        p = Pair(R, capacity_extra=4, retry=dict(
            max_attempts=3, base_delay_s=1e-4, deadline_s=10.0))
        srv = p.t
        srv._onboard = Flaky(srv._onboard, fail_times=99)
        p.j._onboard = jfaults.Flaky(p.j._onboard, fail_times=99)
        info = p.onboard(R[0])
        assert info.user_id == -1 and info.status == "error"
        assert srv.stats.errors == 1
        assert srv.quarantine.counts["error"] == 1
        # The failed attempts never reached the arena.
        assert srv.state.n_active == 30
        del srv._onboard                           # drop the fault wrapper
        p.j._build_jits()
        info = p.onboard(R[0])
        assert info.user_id == 30 and info.status == "ok"
        p.check()


# ---------------------------------------------------------------------------
# Arena rotation under a flood
# ---------------------------------------------------------------------------

class TestArenaRotation:
    def test_flood_past_capacity(self, rng):
        R = make_ratings(rng, n=30, m=12)
        p = Pair(R, capacity_extra=4, c_probes=4)
        srv = p.t
        # The port floods first, so its probes follow the JAX key chain
        # from here on their own (no rollback happens in a flood).
        key = [p.j._key]

        def chain():
            key[0], sub = jax.random.split(key[0])
            return torch.tensor(np.asarray(jax.random.randint(
                sub, (srv.c,), 0, srv.n_base)))

        srv._draw_probes = chain
        results = capacity_flood(srv, R, 14, seed=3)
        jresults = jfaults.capacity_flood(p.j, R, 14, seed=3)
        assert [r.user_id for r in results] == [u for u, _ in jresults]
        assert all(r.status == "ok" for r in results)
        assert [r.user_id for r in results] == list(range(30, 44))
        assert srv.stats.rotations == 3            # 4-slot arena, 14 users
        assert srv.state.n_active == 44
        assert len(p.recommend(43, n=5)) == 5
        p.check()
