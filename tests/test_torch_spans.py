"""The port's span recorder (``repro_torch.spans``): nesting, parents and
self time, the bounded log, device spans (on stand-in CUDA events), the
shared clock with ``torch.profiler``, and the spans a CPU ``CFServer``
records, which feed its ``ServerStats``."""
from __future__ import annotations

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.serving import CFServer, ServerConfig, SnapshotConfig
from repro_torch.spans import RECORDER, Recorder
from tests.conftest import make_ratings

torch.set_num_threads(2)

ONBOARD_TWIN = ["cf_server.guard", "cf_server.upload", "cf_server.compute",
                "twinsearch.search", "twinsearch.copy", "cf_server.commit"]
ONBOARD_FRESH = ["cf_server.guard", "cf_server.upload", "cf_server.compute",
                 "twinsearch.search", "baseline.fallback",
                 "cf_server.commit"]


def _names(entry) -> list[str]:
    return [c[0] for c in entry.children]


def _dur(row) -> int:
    return row[3] - row[2]


def test_nesting_parents_and_self_time():
    rec = Recorder()
    with rec.request("req") as req:
        with rec.span("a") as a:
            with rec.span("b"):
                time.sleep(0.002)
            time.sleep(0.001)
        with rec.span("c") as c:
            pass
    (e,) = rec.entries("req")
    assert _names(e) == ["a", "b", "c"]
    assert [row[1] for row in e.children] == [-1, 0, -1]
    ra, rb, rc = e.children
    assert e.start <= ra[2] <= rb[2] <= rb[3] <= ra[3] <= rc[2] <= rc[3] \
        <= e.end
    assert e.host_ns == req.ns and _dur(ra) == a.ns and _dur(rc) == c.ns
    assert all(row[4] is None for row in e.children)   # no device spans
    bd = spans.breakdown([e, e])        # a request's means over two
    assert bd["b"]["host_ms"] == pytest.approx(_dur(rb) * 1e-6)
    assert bd["b"]["self_ms"] == bd["b"]["host_ms"] >= 2.0
    assert bd["a"]["host_ms"] == pytest.approx(_dur(ra) * 1e-6)
    assert bd["a"]["self_ms"] == pytest.approx(
        (_dur(ra) - _dur(rb)) * 1e-6) and bd["a"]["self_ms"] >= 1.0
    assert bd["req"]["self_ms"] == pytest.approx(
        (e.host_ns - _dur(ra) - _dur(rc)) * 1e-6)
    assert {k: v["per_request"] for k, v in bd.items()} == {
        "req": 1, "a": 1, "b": 1, "c": 1}
    assert bd["a"]["device_ms"] is None


def test_span_outside_a_request_records_nothing():
    rec = Recorder()
    with rec.span("alone", device=True) as s:
        time.sleep(0.001)
    assert s.ns >= 1_000_000 and s.ms == s.ns * 1e-6 and s.t0 > 0
    assert rec.entries() == [] and rec.dropped == 0
    assert rec._pool is None                    # no events were made


def test_request_inside_a_request_is_an_entry_of_its_own():
    rec = Recorder()
    with rec.request("outer"):
        with rec.span("a"):
            with rec.request("inner") as inner:
                with rec.span("b"):
                    pass
        with rec.span("c"):
            pass
    e_in, e_out = rec.entries()
    assert (e_in.name, _names(e_in)) == ("inner", ["b"])
    assert (e_out.name, _names(e_out)) == ("outer", ["a", "c"])
    assert e_out.id < e_in.id and e_in.host_ns == inner.ns
    a = e_out.children[0]
    assert a[2] <= e_in.start <= e_in.end <= a[3]


def test_exception_closes_the_span_and_the_request():
    rec = Recorder()
    with pytest.raises(ValueError):
        with rec.request("req"):
            with rec.span("a"):
                raise ValueError("x")
    (e,) = rec.entries()
    assert _names(e) == ["a"] and e.children[0][3] >= e.children[0][2] > 0
    assert rec._local.entry is None and e.stack == [-1]


def test_bounded_log_counts_what_fell_off():
    rec = Recorder(log_entries=4)
    for _ in range(10):
        with rec.request("r"):
            with rec.span("s"):
                pass
    ids = [e.id for e in rec.entries()]
    assert ids == sorted(ids) == list(range(ids[0], ids[0] + 4))
    assert rec.dropped == 6
    assert all([c[0] for c in e.children] == ["s"] for e in rec.entries())
    rec.clear()
    assert rec.entries() == [] and rec.dropped == 0
    with rec.request("r"):
        pass
    assert rec.entries()[0].id == ids[-1] + 1   # ids keep growing


class _FakeEvent:
    """A stand-in ``torch.cuda.Event`` on the host clock: done once
    recorded."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        _FakeEvent.made += 1
        self.t = None
        self.streams = []

    def record(self, stream=None):
        self.t = time.perf_counter_ns()
        self.streams.append(stream)

    def query(self):
        return self.t is not None

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e-6


@pytest.fixture
def fake_events(monkeypatch):
    _FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: "current")
    return _FakeEvent


def test_device_spans_read_when_the_log_is_read(fake_events):
    rec = Recorder(event_pairs=2)
    stream = object()
    with rec.request("r"):
        with rec.span("dev", device=True):
            time.sleep(0.001)
        with rec.span("on_stream", device=stream):
            pass
        with rec.span("host"):
            pass
    assert fake_events.made == 4                # the pool, made once
    assert rec.log[0].children[0][4] is None    # not read yet
    (e,) = rec.entries()
    dev, on_stream, host = e.children
    assert dev[4] >= 1_000_000 and on_stream[4] >= 0 and host[4] is None
    assert e.device_ns_of("dev") == dev[4]
    assert e.device_ns_of("host") is None
    assert spans.breakdown([e])["dev"]["device_ms"] == dev[4] * 1e-6
    assert rec._pool is not None and len(rec._pool) == 2   # returned
    assert dev[2] > 0 and {p[0].streams[-1] for p in rec._pool} == {
        "current", stream}
    assert e.stream == "current"                # looked up once a request
    # Three device spans before a read on two pairs: the oldest loses its
    # device reading, and no more events are made.
    with rec.request("r"):
        for _ in range(3):
            with rec.span("dev", device=True):
                pass
    assert rec.device_lost == 1 and fake_events.made == 4
    e = rec.entries()[-1]
    assert [row[4] is None for row in e.children] == [True, False, False]
    assert e.device_ns_of("dev") is None


def test_spans_share_the_profilers_clock_and_stay_out_of_it():
    rec = Recorder()
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.request("spans_test.request"):
            with rec.span("spans_test.child"):
                torch.mm(x, x)
    (e,) = rec.entries()
    events = list(prof.profiler.kineto_results.events())
    mm = [ev for ev in events if ev.name() == "aten::mm"]
    assert mm
    slack = 100_000                              # 0.1 ms
    child = e.children[0]
    for ev in mm:
        s, t = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        assert e.start - slack <= s and t <= e.end + slack
        assert child[2] - slack <= s and t <= child[3] + slack
    names = {ev.name() for ev in events}
    assert not names & {"spans_test.request", "spans_test.child"}


# -- the spans of a CPU CFServer ---------------------------------------------

@pytest.fixture
def server():
    R = make_ratings(np.random.default_rng(3), n=96, m=40)
    cfg = ServerConfig(capacity_extra=16, c_probes=4,
                       snapshot=SnapshotConfig(every=16, check_every=8))
    srv = CFServer(R, cfg, device="cpu")
    return srv, R


def _fresh(rng, m):
    r = (rng.integers(1, 6, m) * (rng.random(m) < 0.5)).astype(np.float32)
    r[0] = 5.0
    return r


def test_construction_is_a_request():
    RECORDER.clear()
    R = make_ratings(np.random.default_rng(4), n=48, m=24)
    srv = CFServer(R, ServerConfig(capacity_extra=8), device="cpu")
    (e,) = RECORDER.entries("cf_server.init")
    assert _names(e) == ["cf_server.snapshot"]
    assert srv.stats.snapshots == 1


def test_onboard_spans_in_order(server):
    srv, R = server
    rng = np.random.default_rng(5)
    RECORDER.clear()
    assert srv.onboard_user(R[7].copy()).twin_found
    assert not srv.onboard_user(_fresh(rng, R.shape[1])).twin_found
    bad = srv.onboard_user(np.full(R.shape[1], 9.0, np.float32))
    assert bad.status == "rejected"
    twin, fresh, rejected = RECORDER.entries("cf_server.onboard_user")
    assert _names(twin) == ONBOARD_TWIN
    assert _names(fresh) == ONBOARD_FRESH
    assert _names(rejected) == ["cf_server.guard"]
    for e in (twin, fresh):
        rows = e.children
        compute = rows[2]
        assert [r[1] for r in rows] == [-1, -1, -1, 2, 2, -1]
        assert compute[2] <= rows[3][2] <= rows[4][3] <= compute[3]
    assert twin.id + 1 == fresh.id
    assert srv.stats.onboard_ms[-2] == _dur(twin.children[2]) * 1e-6
    assert srv.stats.onboard_ms[-1] == _dur(fresh.children[2]) * 1e-6


def test_health_rotation_and_snapshot_spans_feed_the_stats(server):
    srv, R = server
    rng = np.random.default_rng(6)
    RECORDER.clear()
    for i in range(16):
        r = R[i].copy() if i % 2 else _fresh(rng, R.shape[1])
        assert srv.onboard_user(r).ok
    log = RECORDER.entries("cf_server.onboard_user")
    assert len(log) == 16
    health = [c for e in log for c in e.rows("cf_server.health")]
    # The checks after the 8th and the 16th onboard, and the 16th's
    # snapshot's own sweep.
    assert len(health) == 3
    assert [len(e.rows("cf_server.health")) for e in log].count(2) == 1
    assert _names(log[15])[-3:] == ["cf_server.health", "cf_server.health",
                                    "cf_server.snapshot"]
    assert srv.stats.rotations == 0
    res = srv.onboard_user(_fresh(rng, R.shape[1]))     # the arena is full
    assert res.ok and res.rotated and srv.stats.rotations == 1
    e = RECORDER.entries("cf_server.onboard_user")[-1]
    names = _names(e)
    rot = names.index("cf_server.rotate")
    assert names[:rot] == ["cf_server.guard"]
    inside = [c for c in e.children if c[1] == rot]
    assert {c[0] for c in inside} == {"rotation.recover", "rotation.merge",
                                      "rotation.assemble"}
    assert inside[0][0] == "rotation.recover"
    assert inside[-1][0] == "rotation.assemble"
    # Every merge chunk re-sorts and merges its base rows: one chunk here.
    assert len(e.rows("rotation.merge")) == 1
    assert srv.stats.rotation_ms[-1] == _dur(e.children[rot]) * 1e-6
    assert srv.stats.rotation_pause_ms[-1] == srv.stats.rotation_ms[-1]
    # Each deque holds what its spans measured, as many as its counter.
    log = RECORDER.entries("cf_server.onboard_user")
    computes = [_dur(c) * 1e-6 for e in log
                for c in e.rows("cf_server.compute")]
    assert list(srv.stats.onboard_ms)[-len(computes):] == computes
    assert len(srv.stats.onboard_ms) == srv.stats.onboarded == 17
    assert len(srv.stats.rotation_ms) == srv.stats.rotations == 1
    snaps = [c for e in RECORDER.entries()
             for c in e.rows("cf_server.snapshot")]
    assert len(snaps) == 1 and srv.stats.snapshots == 2     # + the init's


def test_read_spans_feed_query_ms(server):
    srv, R = server
    RECORDER.clear()
    srv.recommend_batch([0, 1, 1, 5], n=5, k_neighbors=4)
    srv.predict_batch([0, 2], [1, 3], k=4)
    rec, pred = RECORDER.entries()
    assert rec.name == "cf_server.recommend_batch"
    assert _names(rec) == ["knn.top_k", "dedup.keys", "dedup.hash",
                           "knn.score", "cf_server.fan_out"]
    assert pred.name == "cf_server.predict_batch"
    assert _names(pred) == ["knn.top_k", "dedup.keys", "dedup.hash",
                            "knn.predict", "cf_server.fan_out"]
    for e, ms in zip((rec, pred), list(srv.stats.query_ms)[-2:]):
        assert ms == (e.children[3][3] - e.children[0][2]) * 1e-6
    assert srv.stats.query_batches == 2 and len(srv.stats.query_ms) == 2


def test_write_path_spans(tmp_path):
    from repro_torch.serving import RotationConfig, WalConfig
    R = make_ratings(np.random.default_rng(7), n=48, m=24)
    cfg = ServerConfig(capacity_extra=8, c_probes=4,
                       snapshot=SnapshotConfig(every=4, check_every=2,
                                               dir=str(tmp_path / "ck")),
                       wal=WalConfig(dir=str(tmp_path / "wal"), fsync=False),
                       rotation=RotationConfig(budget_rows=16,
                                               reserve_slots=4))
    RECORDER.clear()
    srv = CFServer(R, cfg, device="cpu")
    rng = np.random.default_rng(8)
    for _ in range(6):
        srv.onboard_user(_fresh(rng, R.shape[1]))
    assert srv.add_rating(3, 5, 4.0)
    srv.step_maintenance()
    st = srv.stats
    count = {}
    for e in RECORDER.entries():
        for c in e.children:
            count[c[0]] = count.get(c[0], 0) + 1
    assert count["cf_server.wal_append"] == len(st.wal_append_ms) \
        == st.wal_appends
    assert count["cf_server.snapshot_save"] == len(st.snapshot_save_ms) \
        == st.snapshots
    assert count["cf_server.cache_init"] == len(st.cache_init_ms) == 1
    assert count["cf_server.apply_rating"] == len(st.add_rating_ms) == 1
    assert count.get("cf_server.plan_step", 0) == len(st.plan_step_ms) > 0
    names = {e.name for e in RECORDER.entries()}
    assert {"cf_server.init", "cf_server.onboard_user",
            "cf_server.add_rating", "cf_server.step_maintenance"} <= names
    rec = CFServer.recover(R, cfg, device="cpu")
    init = RECORDER.entries("cf_server.init")[-1]
    assert "cf_server.recover_restore" in _names(init)
    assert rec.stats.recover_restore_ms == _dur(
        init.rows("cf_server.recover_restore")[0]) * 1e-6


def test_server_steps_outside_a_request_still_feed_the_stats(server):
    # A private step driven with no request open records no span, and the
    # ServerStats timings its spans feed still read.
    srv, R = server
    RECORDER.clear()
    st = srv.stats
    snaps, rots = st.snapshots, st.rotations
    srv._take_snapshot()
    srv._rotate()
    srv._recommend_batch([0, 1, 1], 5, 4)
    srv._predict_batch([0, 2], [1, 3], 4)
    assert st.snapshots == snaps + 1 and st.rotations == rots + 1
    assert len(st.rotation_ms) == 1 and st.rotation_ms[-1] > 0
    assert st.rotation_pause_ms[-1] == st.rotation_ms[-1]
    assert len(st.query_ms) == 2 and min(st.query_ms) > 0
    assert RECORDER.entries() == []
