"""Crash recovery of the port's server: ports of ``TestCrashRecovery`` and
``TestIncrementalRotationCrash`` from ``tests/test_resilience.py``, and
recovery across packages (a JAX server's WAL and checkpoint replayed by the
port, and the reverse).

Tolerances: within the port, a crashed and recovered server is
bit-identical to an uncrashed one on all five leaves, ``n_base`` and
capacity.  Across packages: ``n_active``, ``n_base``, capacity, ratings,
twin flags and counters exact; lists under ``bridge.lists_match`` at 1e-6
(rows a similarity computation built round differently per package).
Every server runs its ladder monitor on a virtual clock, so wall-clock
noise cannot move a request off the twin-search path.
"""
from __future__ import annotations

import itertools
import os
import shutil

import numpy as np
import pytest
import torch

from repro.serving import CFServer as JServer
from repro.serving import ServerConfig as JConfig
from repro.training.elastic import StragglerMonitor as JMonitor
from repro_torch.bridge import lists_match, state_to_numpy
from repro_torch.core import rotate_arena_frozen
from repro_torch.serving import (CFServer, RotationConfig, ServerConfig,
                                 SnapshotConfig, WalConfig)
from repro_torch.serving.guard import RetryPolicy
from repro_torch.testing import (CRASH_POINTS, ROTATION_CRASH_POINTS, Flaky,
                                 SimulatedCrash, install_crash)
from repro_torch.training import checkpoint
from repro_torch.training.elastic import StragglerMonitor
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def _assert_states_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for f in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"field {f}")
    assert int(a["n_active"]) == int(b["n_active"])


KNOBS = dict(capacity_extra=6, c_probes=4, snapshot_every=5, check_every=3)
FAST_RETRY = dict(max_attempts=2, base_delay_s=1e-4, deadline_s=10.0,
                  sleep=lambda s: None)


def _cfg(tmp_path, tag, **extra) -> ServerConfig:
    kw = {**KNOBS, **extra}
    if tag is not None:
        kw.setdefault("wal_dir", str(tmp_path / f"{tag}-wal"))
        kw.setdefault("snapshot_dir", str(tmp_path / f"{tag}-snap"))
    return ServerConfig.from_kwargs(**kw,
                                    monitor=StragglerMonitor(clock=_clock()))


def _server(R, tmp_path, tag, **extra) -> CFServer:
    return CFServer(R, _cfg(tmp_path, tag, **extra), device="cpu")


def _recover(R, tmp_path, tag, **extra) -> CFServer:
    return CFServer.recover(R, _cfg(tmp_path, tag, **extra), device="cpu")


def _pool(R):
    fresh = make_ratings(np.random.default_rng(101), n=6, m=R.shape[1])
    # mix of twins (base copies) and fresh rows: both onboard paths
    return np.concatenate([R[:3], fresh, R[5:8]], axis=0)


def test_crash_points_are_the_references():
    from repro.testing import faults as jfaults
    assert CRASH_POINTS == jfaults.CRASH_POINTS
    assert ROTATION_CRASH_POINTS == jfaults.ROTATION_CRASH_POINTS


class TestCrashRecovery:
    @pytest.mark.parametrize("point,nth", [
        ("onboard.pre_wal", 4),
        ("onboard.post_wal", 4),
        ("onboard.post_commit", 4),
        ("rotate.post_wal", 1),                 # fires at the 7th onboard
    ])
    def test_kill_and_restart_bit_exact(self, rng, tmp_path, point, nth):
        """A crash at any injected crash point mid-sequence, recovered via
        checkpoint + WAL replay, converges to the exact same arena as an
        uncrashed run over the same request sequence."""
        R = make_ratings(rng, n=40, m=16)
        pool = _pool(R)
        n_ops = 10                              # > capacity_extra: rotates

        oracle = _server(R, tmp_path, "oracle")
        for i in range(n_ops):
            assert oracle.onboard_user(pool[i % len(pool)]).ok

        victim = _server(R, tmp_path, "victim")
        install_crash(victim, point, nth=nth)
        with pytest.raises(SimulatedCrash) as e:
            for i in range(n_ops):
                victim.onboard_user(pool[i % len(pool)])
        assert e.value.point == point

        recovered = _recover(R, tmp_path, "victim")
        # ops already applied (replayed or checkpointed) are not re-issued;
        # everything else is, as a client retry would
        applied = recovered.state.n_active - 40
        for i in range(applied, n_ops):
            assert recovered.onboard_user(pool[i % len(pool)]).ok

        _assert_states_equal(recovered.state, oracle.state)
        assert recovered.n_base == oracle.n_base
        assert recovered.state.capacity == oracle.state.capacity
        assert recovered._gen.get_state().equal(oracle._gen.get_state())
        assert recovered.recommend(5, n=5) == oracle.recommend(5, n=5)

    @pytest.mark.parametrize("point,applied", [
        ("add_rating.pre_wal", False),          # op lost: not yet logged
        ("add_rating.post_wal", True),          # logged: replay applies it
        ("add_rating.post_commit", True),
    ])
    def test_crash_around_add_rating(self, rng, tmp_path, point, applied):
        R = make_ratings(rng, n=30, m=12)
        oracle = _server(R, tmp_path, "oracle")
        for i in range(3):
            oracle.onboard_user(R[i])
        if applied:
            assert oracle.add_rating(2, 3, 4.0)

        victim = _server(R, tmp_path, "victim")
        for i in range(3):
            victim.onboard_user(R[i])
        install_crash(victim, point)
        with pytest.raises(SimulatedCrash):
            victim.add_rating(2, 3, 4.0)

        recovered = _recover(R, tmp_path, "victim")
        _assert_states_equal(recovered.state, oracle.state)

    def test_recovery_with_wal_only(self, rng, tmp_path):
        """No disk checkpoints at all: replay runs over a fresh build of
        the same base ratings and still lands bit-exact."""
        R = make_ratings(rng, n=30, m=12)
        wal = str(tmp_path / "wal")
        srv = _server(R, tmp_path, None, wal_dir=wal)
        for i in range(8):                      # crosses one rotation
            srv.onboard_user(R[i])
        srv.add_rating(1, 2, 3.0)

        recovered = _recover(R, tmp_path, None, wal_dir=wal)
        assert recovered.stats.wal_replayed == len(srv.wal.records())
        _assert_states_equal(recovered.state, srv.state)

    def test_aborted_onboard_not_replayed(self, rng, tmp_path):
        """An onboard that failed after its WAL append leaves an abort
        record; recovery must skip it."""
        R = make_ratings(rng, n=30, m=12)
        srv = _server(R, tmp_path, "victim", retry=RetryPolicy(**FAST_RETRY))
        srv.onboard_user(R[0])
        srv._onboard = Flaky(srv._onboard, fail_times=99)
        assert srv.onboard_user(R[1]).status == "error"
        del srv._onboard                        # drop the fault wrapper
        srv.onboard_user(R[2])

        recovered = _recover(R, tmp_path, "victim")
        _assert_states_equal(recovered.state, srv.state)

    def test_aborted_tail_never_reuses_seqs(self, rng, tmp_path):
        """Crash right after an onboard aborts: recovery resumes numbering
        past the abort record, so a later recovery cannot drop the next
        committed op as aborted."""
        R = make_ratings(rng, n=30, m=12)
        srv = _server(R, tmp_path, "victim", retry=RetryPolicy(**FAST_RETRY))
        srv.onboard_user(R[0])
        srv._onboard = Flaky(srv._onboard, fail_times=99)
        assert srv.onboard_user(R[1]).status == "error"   # WAL tail = abort

        r1 = _recover(R, tmp_path, "victim")
        assert r1._seq >= r1.wal.last_seq           # numbering moved past
        assert r1.onboard_user(R[2]).ok             # committed + acked

        r2 = _recover(R, tmp_path, "victim")        # second kill-and-restart
        _assert_states_equal(r2.state, r1.state)

    def test_wal_only_recovery_with_aborted_first_op(self, rng, tmp_path):
        R = make_ratings(rng, n=30, m=12)
        wal = str(tmp_path / "wal")
        srv = _server(R, tmp_path, None, wal_dir=wal,
                      retry=RetryPolicy(**FAST_RETRY))
        srv._onboard = Flaky(srv._onboard, fail_times=99)
        assert srv.onboard_user(R[0]).status == "error"   # seq 1 aborted
        del srv._onboard
        srv.onboard_user(R[1])

        recovered = _recover(R, tmp_path, None, wal_dir=wal)  # no raise
        _assert_states_equal(recovered.state, srv.state)

    @pytest.mark.parametrize("snapshot_every,wal_empty", [
        (2, True),      # WAL truncated through the corrupt newest step
        (4, False),     # WAL holds a suffix, but past the gap
    ])
    def test_fallback_over_truncated_wal_fails_loudly(self, rng, tmp_path,
                                                      snapshot_every,
                                                      wal_empty):
        R = make_ratings(rng, n=30, m=12)
        srv = _server(R, tmp_path, "victim", snapshot_every=snapshot_every)
        for i in range(6):
            assert srv.onboard_user(R[i]).ok
        assert (len(srv.wal.records()) == 0) == wal_empty

        snap = tmp_path / "victim-snap"
        steps = checkpoint.all_steps(str(snap))
        assert len(steps) >= 2
        step_dir = snap / f"step_{steps[-1]:010d}"
        leaf = next(p for p in sorted(step_dir.iterdir())
                    if p.suffix == ".npy" and p.stat().st_size > 200)
        with open(leaf, "r+b") as f:             # flip data bytes, keep
            f.seek(-4, os.SEEK_END)              # the .npy header valid
            f.write(b"\xde\xad\xbe\xef")

        with pytest.raises(RuntimeError, match="gap|truncated"):
            _recover(R, tmp_path, "victim", snapshot_every=snapshot_every)

    def test_recovery_converges_after_repeated_crashes(self, rng, tmp_path):
        R = make_ratings(rng, n=30, m=12)
        srv = _server(R, tmp_path, "victim")
        for i in range(4):
            srv.onboard_user(R[i])
        for _ in range(3):                      # repeated kill-and-restart
            srv = _recover(R, tmp_path, "victim")
        oracle = _server(R, tmp_path, "oracle")
        for i in range(4):
            oracle.onboard_user(R[i])
        _assert_states_equal(srv.state, oracle.state)


class TestIncrementalRotationCrash:
    """Crash mid-partial-rotation: recovery lands bit-exact at every
    injected point."""

    def _config(self, tmp_path, tag):
        return ServerConfig(
            capacity_extra=6, c_probes=4,
            snapshot=SnapshotConfig(every=100, check_every=100,
                                    dir=str(tmp_path / f"{tag}-snap")),
            wal=WalConfig(dir=str(tmp_path / f"{tag}-wal")),
            rotation=RotationConfig(budget_rows=2))

    def _crash_run(self, R, tmp_path, point):
        cfg = self._config(tmp_path, "victim")
        victim = CFServer(R, cfg, device="cpu")
        install_crash(victim, point, nth=1)
        with pytest.raises(SimulatedCrash) as e:
            for i in range(10):
                victim.onboard_user(R[i])
        assert e.value.point == point
        return cfg, victim

    def test_crash_on_precompute_step_loses_nothing(self, rng, tmp_path):
        R = make_ratings(rng, n=30, m=12)
        cfg, victim = self._crash_run(R, tmp_path, "rotation.step")
        recovered = CFServer.recover(R, cfg, device="cpu")
        _assert_states_equal(recovered.state, victim.state)
        assert recovered.n_base == victim.n_base

    def test_crash_after_commit_record_replays_the_swap(self, rng,
                                                        tmp_path):
        R = make_ratings(rng, n=30, m=12)
        cfg, victim = self._crash_run(R, tmp_path,
                                      "rotation.commit_post_wal")
        plan = victim._plan
        assert plan is not None and plan.done
        expected = rotate_arena_frozen(victim.state, n_base=plan.n_base,
                                       n_frozen=plan.n_frozen,
                                       extra=plan.extra)
        recovered = CFServer.recover(R, cfg, device="cpu")
        _assert_states_equal(recovered.state, expected)
        assert recovered.n_base == plan.n_frozen
        assert recovered.stats.rotations == 1

    def test_crash_after_swap_recovers_the_swap(self, rng, tmp_path):
        R = make_ratings(rng, n=30, m=12)
        cfg, victim = self._crash_run(R, tmp_path, "rotation.post_swap")
        recovered = CFServer.recover(R, cfg, device="cpu")
        _assert_states_equal(recovered.state, victim.state)
        assert recovered.n_base == victim.n_base
        assert recovered.state.capacity == victim.state.capacity

    @pytest.mark.parametrize("point", ROTATION_CRASH_POINTS)
    def test_recovered_run_converges_with_uncrashed(self, rng, tmp_path,
                                                    point):
        R = make_ratings(rng, n=30, m=12)
        n_ops = 10
        oracle = CFServer(R, self._config(tmp_path, "oracle"), device="cpu")
        for i in range(n_ops):
            assert oracle.onboard_user(R[i]).ok

        cfg, _ = self._crash_run(R, tmp_path, point)
        recovered = CFServer.recover(R, cfg, device="cpu")
        applied = recovered.state.n_active - 30
        for i in range(applied, n_ops):
            assert recovered.onboard_user(R[i]).ok
        _assert_states_equal(recovered.state, oracle.state)
        assert recovered.n_base == oracle.n_base


def test_incremental_run_with_add_ratings_recovers_bit_exact(rng, tmp_path):
    """A mid-run checkpoint, add_ratings on base and frozen burst rows
    while a plan is in flight (dirty rows, a restart), and the swap in the
    WAL suffix: recovery from checkpoint + WAL equals the live state."""
    R = make_ratings(rng, n=30, m=12)
    pool = _pool(R)
    cfg = ServerConfig(
        capacity_extra=8, c_probes=4,
        snapshot=SnapshotConfig(every=7, check_every=2, keep=1,
                                dir=str(tmp_path / "snap")),
        wal=WalConfig(dir=str(tmp_path / "wal")),
        rotation=RotationConfig(budget_rows=7))
    srv = CFServer(R, cfg, device="cpu")
    for i in range(6):
        assert srv.onboard_user(pool[i]).ok
    srv.step_maintenance()                      # free slots 2: plan starts
    assert srv._plan is not None
    assert srv.add_rating(4, 1, 5.0)            # dirty base row
    assert srv.add_rating(31, 2, 1.0)           # frozen burst row: restart
    for i in range(6, 13):
        assert srv.onboard_user(pool[i % len(pool)]).ok
        assert srv.add_rating(i, i % 12, 2.0)
    assert srv.stats.rotations == 1 and srv.stats.plan_restarts == 1
    assert len(checkpoint.all_steps(str(tmp_path / "snap"))) == 1
    suffix = [r.op for r in srv.wal.records()]
    assert "rotate_commit" in suffix and "add_rating" in suffix, suffix
    live = state_to_numpy(srv.state)

    recovered = CFServer.recover(R, cfg, device="cpu")
    assert recovered.stats.wal_replayed == len(suffix)
    rec = state_to_numpy(recovered.state)
    for key in live:
        np.testing.assert_array_equal(rec[key], live[key], err_msg=key)
    assert recovered.n_base == srv.n_base
    assert recovered._gen.get_state().equal(srv._gen.get_state())


def test_write_path_timings_in_server_stats(rng, tmp_path):
    """ServerStats times every WAL append, applied add_rating, dots-cache
    build, maintenance-tick plan step and durable save, and ``recover``'s
    restore and replay; a refused add_rating adds no time."""
    R = make_ratings(rng, n=30, m=12)
    pool = _pool(R)
    cfg = ServerConfig(
        capacity_extra=8, c_probes=4,
        snapshot=SnapshotConfig(every=7, keep=1, dir=str(tmp_path / "snap")),
        wal=WalConfig(dir=str(tmp_path / "wal")),
        rotation=RotationConfig(budget_rows=7))
    srv = CFServer(R, cfg, device="cpu")
    for i in range(8):
        assert srv.onboard_user(pool[i]).ok
    assert srv.add_rating(4, 1, 5.0) and srv.add_rating(5, 2, 0.0)
    assert not srv.add_rating(4, 99, 5.0)        # refused: no time, no WAL
    srv.step_maintenance()
    st = srv.stats
    assert len(st.wal_append_ms) == st.wal_appends > 0
    assert len(st.add_rating_ms) == 2
    assert len(st.cache_init_ms) == 1
    assert len(st.plan_step_ms) >= 1
    assert len(st.snapshot_save_ms) == st.snapshots == 2
    s = srv.stats.summary()
    assert s["add_rating_p99_ms"] >= s["add_rating_p50_ms"] > 0.0
    assert s["wal_append_p99_ms"] >= s["wal_append_p50_ms"] > 0.0
    assert s["plan_step_max_ms"] >= s["plan_step_p50_ms"] > 0.0
    assert s["cache_init_max_ms"] > 0.0 and s["snapshot_save_max_ms"] > 0.0
    assert s["recover_restore_ms"] == s["recover_replay_ms"] == 0.0

    rec = CFServer.recover(R, cfg, device="cpu")
    assert rec.stats.wal_replayed > 0
    assert rec.stats.recover_restore_ms > 0.0
    assert rec.stats.recover_replay_ms > 0.0
    assert len(rec.stats.wal_append_ms) == 0     # replay appends nothing


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _script(srv, R, fresh):
    """Twin and traditional onboards, add_ratings, and (capacity 6) one
    synchronous rotation; with snapshots every 5 onboards, the checkpoint
    is taken at the 5th and the WAL suffix holds the rest."""
    for r in (R[3], fresh[0], R[10], fresh[1], R[3], fresh[2]):
        assert srv.onboard_user(r).ok
    for u, i, v in ((2, 1, 5.0), (41, 3, 4.0), (7, 0, 0.0)):
        assert srv.add_rating(u, i, v)
    for r in (R[17], fresh[3], R[25]):
        assert srv.onboard_user(r).ok


def _assert_cross(a: dict, b: dict):
    assert int(a["n_active"]) == int(b["n_active"])
    np.testing.assert_array_equal(a["ratings"], b["ratings"])
    np.testing.assert_allclose(a["norms"], b["norms"], atol=1e-6, rtol=0)
    assert lists_match(a["sim_vals"], a["sim_idx"], b["sim_vals"],
                       b["sim_idx"], 1e-6) is None


def _jnp_state(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_recovery_across_packages(rng, tmp_path, writer):
    """One package serves and crashes; the other recovers from its
    checkpoint + WAL (a copy, since recovery writes its own snapshot)."""
    R = make_ratings(rng, n=40, m=16)
    fresh = make_ratings(np.random.default_rng(7), n=4, m=16)
    live_dirs = dict(wal_dir=str(tmp_path / "wal"),
                     snapshot_dir=str(tmp_path / "snap"))
    if writer == "jax":
        live = JServer(R, JConfig.from_kwargs(
            **KNOBS, **live_dirs, monitor=JMonitor(clock=_clock())))
    else:
        live = _server(R, tmp_path, None, **live_dirs)
    _script(live, R, fresh)
    assert live.stats.rotations == 1 and live.stats.snapshots >= 2
    for d in ("wal", "snap"):
        shutil.copytree(tmp_path / d, tmp_path / f"copy-{d}")
    dirs = dict(wal_dir=str(tmp_path / "copy-wal"),
                snapshot_dir=str(tmp_path / "copy-snap"))

    if writer == "jax":
        rec = _recover(R, tmp_path, None, **dirs)
        a, b = _jnp_state(live.state), state_to_numpy(rec.state)
    else:
        rec = JServer.recover(R, JConfig.from_kwargs(
            **KNOBS, **dirs, monitor=JMonitor(clock=_clock())))
        a, b = state_to_numpy(live.state), _jnp_state(rec.state)
    assert rec.n_base == live.n_base
    assert rec.state.capacity == live.state.capacity
    assert rec.stats.wal_replayed == len(live.wal.records()) == 8
    assert rec.stats.rotations == live.stats.rotations == 1
    _assert_cross(a, b)
