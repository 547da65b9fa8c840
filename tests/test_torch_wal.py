"""The port's write-ahead log (``repro_torch.serving.wal``): ports of
``TestWriteAheadLog`` and ``TestWalGroupCommit`` from
``tests/test_resilience.py``, and the cross-package contract — a log
written by either package is read by the other, and the same appends give
byte-identical files.

Tolerance: none.  Records carry raw array bytes and JSON scalars; seqs,
ops, fields and arrays must round-trip exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.serving.wal import WriteAheadLog as JWal
from repro_torch.bridge import state_to_numpy
from repro_torch.serving import CFServer, ServerConfig, WalConfig
from repro_torch.serving.wal import WriteAheadLog
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _assert_states_equal(a, b):
    a, b = state_to_numpy(a), state_to_numpy(b)
    for f in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"field {f}")


class TestWriteAheadLog:
    def test_roundtrip_bit_exact(self, tmp_path, rng):
        wal = WriteAheadLog(str(tmp_path))
        r = rng.normal(size=(16,)).astype(np.float32)
        p = rng.integers(0, 40, size=4).astype(np.int32)
        wal.append(1, "onboard", {"use_twin": True},
                   {"ratings": r, "probes": p})
        wal.append(2, "add_rating", {"user": 3, "item": 5, "rating": 4.0})
        wal.append(3, "rotate")
        wal.close()

        recs = WriteAheadLog(str(tmp_path)).records()     # reopen
        assert [x.seq for x in recs] == [1, 2, 3]
        assert [x.op for x in recs] == ["onboard", "add_rating", "rotate"]
        np.testing.assert_array_equal(recs[0].arrays["ratings"], r)
        np.testing.assert_array_equal(recs[0].arrays["probes"], p)
        assert recs[0].fields == {"use_twin": True}
        assert recs[1].fields["rating"] == 4.0

    def test_torn_tail_is_repaired(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        for s in range(1, 4):
            wal.append(s, "add_rating", {"user": s, "item": 0,
                                         "rating": 1.0})
        wal.close()
        with open(wal.path, "r+b") as f:           # tear mid-record
            f.truncate(wal.size_bytes() - 7)
        wal2 = WriteAheadLog(str(tmp_path))
        assert [x.seq for x in wal2.records()] == [1, 2]
        wal2.append(3, "rotate")                   # appendable after repair
        assert [x.seq for x in wal2.records()] == [1, 2, 3]

    def test_truncation_policies(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        for s in range(1, 6):
            wal.append(s, "rotate")
        wal.truncate_through(3)                    # durable snapshot at 3
        assert [x.seq for x in wal.records()] == [4, 5]
        wal.truncate_after(4)                      # rollback to 4
        assert [x.seq for x in wal.records()] == [4]
        assert wal.truncations == 2

    def test_aborted_ops_are_filtered(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        wal.append(1, "onboard", {"use_twin": False})
        wal.append(2, "onboard", {"use_twin": False})
        wal.append(3, "abort", {"target": 2})      # op 2 failed after log
        wal.append(4, "rotate")
        assert [x.seq for x in wal.records()] == [1, 4]

    def test_fsync_off_still_readable(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path), fsync=False)
        wal.append(1, "rotate")
        assert len(WriteAheadLog(str(tmp_path)).records()) == 1

    def test_raw_bounds_include_aborts(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        assert (wal.first_seq, wal.last_seq) == (0, 0)
        wal.append(1, "onboard", {"use_twin": False})
        wal.append(2, "abort", {"target": 1})
        assert (wal.first_seq, wal.last_seq) == (1, 2)
        wal.close()
        wal2 = WriteAheadLog(str(tmp_path))        # bounds survive reopen
        assert (wal2.first_seq, wal2.last_seq) == (1, 2)
        assert wal2.records() == []                # yet nothing replays

    def test_truncate_after_rewinds_last_seq(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        for s in range(1, 6):
            wal.append(s, "rotate")
        wal.truncate_after(2)
        assert wal.last_seq == 2
        wal.truncate_after(0)                      # drops every record
        assert (wal.first_seq, wal.last_seq) == (0, 0)

    def test_truncate_through_keeps_last_seq(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path))
        for s in range(1, 4):
            wal.append(s, "rotate")
        wal.truncate_through(3)                    # empties the log
        assert (wal.first_seq, wal.last_seq) == (0, 3)
        wal.append(4, "rotate")
        assert (wal.first_seq, wal.last_seq) == (4, 4)


class TestWalGroupCommit:
    def _rec(self, i):
        return dict(fields={"i": i},
                    arrays={"x": np.full(4, i, np.float32)})

    def test_batch_coalesces_into_one_sync(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"))
        with wal.batch():
            for i in range(5):
                wal.append(i + 1, "onboard", **self._rec(i))
            assert wal.syncs == 0            # nothing flushed mid-batch
        assert wal.syncs == 1                # one write+fsync for all 5
        assert [r.seq for r in wal.records()] == [1, 2, 3, 4, 5]
        assert wal.appended == 5 and len(wal) == 5

    def test_unbatched_appends_sync_each(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"))
        for i in range(5):
            wal.append(i + 1, "onboard", **self._rec(i))
        assert wal.syncs == 5

    def test_batched_records_survive_reopen(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"))
        with wal.batch():
            for i in range(3):
                wal.append(i + 1, "onboard", **self._rec(i))
        wal.close()
        recs = WriteAheadLog(str(tmp_path / "w")).records()
        assert [r.seq for r in recs] == [1, 2, 3]
        np.testing.assert_array_equal(recs[2].arrays["x"],
                                      np.full(4, 2, np.float32))

    def test_reads_and_truncation_flush_pending(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"))
        with wal.batch():
            wal.append(1, "onboard", **self._rec(1))
            assert [r.seq for r in wal.records()] == [1]
            assert wal.syncs == 1
            wal.append(2, "onboard", **self._rec(2))
            wal.truncate_after(1)            # flushes, then rewrites
            assert len(wal) == 1 and wal.last_seq == 1
        assert [r.seq for r in wal.records()] == [1]

    def test_nested_batches_flush_once_at_outermost(self, tmp_path):
        wal = WriteAheadLog(str(tmp_path / "w"))
        with wal.batch():
            wal.append(1, "onboard", **self._rec(1))
            with wal.batch():
                wal.append(2, "onboard", **self._rec(2))
            assert wal.syncs == 0            # inner exit does not flush
        assert wal.syncs == 1

    def test_onboard_batch_one_fsync_and_bit_exact_recovery(self, rng,
                                                            tmp_path):
        R = make_ratings(rng, n=24, m=12)
        cfg = ServerConfig(capacity_extra=16, c_probes=4,
                           wal=WalConfig(dir=str(tmp_path / "wal")))
        srv = CFServer(R, cfg, device="cpu")
        results = srv.onboard_batch([R[i] for i in range(5)])
        assert all(r.ok for r in results)
        assert srv.wal.syncs == 1            # the whole batch: one fsync
        recovered = CFServer.recover(R, cfg, device="cpu")
        _assert_states_equal(recovered.state, srv.state)

    def test_group_commit_off_syncs_per_record(self, rng, tmp_path):
        R = make_ratings(rng, n=24, m=12)
        cfg = ServerConfig(capacity_extra=16, c_probes=4,
                           wal=WalConfig(dir=str(tmp_path / "wal"),
                                         group_commit=False))
        srv = CFServer(R, cfg, device="cpu")
        srv.onboard_batch([R[i] for i in range(5)])
        assert srv.wal.syncs == 5


# ---------------------------------------------------------------------------
# Across packages
# ---------------------------------------------------------------------------

def _appends(rng):
    r = rng.normal(size=(16,)).astype(np.float32)
    p = rng.integers(0, 40, size=4).astype(np.int32)
    return [(1, "onboard", {"use_twin": True},
             {"ratings": r, "probes": p}),
            (2, "onboard", {"use_twin": False},
             {"ratings": r * 2, "probes": np.empty((0,), np.int32)}),
            (3, "add_rating", {"user": 3, "item": 5, "rating": 4.0}, None),
            (4, "abort", {"target": 2}, None),
            (5, "rotate_commit", {"n_base": 40, "n_frozen": 46,
                                  "extra": 8}, None),
            (6, "rotate", None, None)]


@pytest.mark.parametrize("writer,reader", [(JWal, WriteAheadLog),
                                           (WriteAheadLog, JWal)],
                         ids=["jax_to_port", "port_to_jax"])
def test_log_written_by_one_package_reads_in_the_other(tmp_path, rng,
                                                       writer, reader):
    ops = _appends(rng)
    w = writer(str(tmp_path))
    with w.batch():
        for seq, op, fields, arrays in ops[:3]:
            w.append(seq, op, fields, arrays)
    for seq, op, fields, arrays in ops[3:]:
        w.append(seq, op, fields, arrays)
    w.close()
    r = reader(str(tmp_path))
    assert (r.first_seq, r.last_seq, len(r)) == (1, 6, 6)
    recs = r.records()
    assert [x.seq for x in recs] == [1, 3, 5, 6]   # op 2 aborted
    by_seq = {seq: (op, fields, arrays) for seq, op, fields, arrays in ops}
    for rec in recs:
        op, fields, arrays = by_seq[rec.seq]
        assert rec.op == op and rec.fields == (fields or {})
        assert set(rec.arrays) == set(arrays or {})
        for name, a in (arrays or {}).items():
            assert rec.arrays[name].dtype == a.dtype
            np.testing.assert_array_equal(rec.arrays[name], a)


def test_same_appends_give_byte_identical_files(tmp_path, rng):
    ops = _appends(rng)
    paths = []
    for cls, tag in ((JWal, "jax"), (WriteAheadLog, "port")):
        w = cls(str(tmp_path / tag), fsync=False)
        for seq, op, fields, arrays in ops:
            w.append(seq, op, fields, arrays)
        w.truncate_through(1)
        w.close()
        paths.append(w.path)
    a, b = (open(p, "rb").read() for p in paths)
    assert len(a) > 100 and a == b
