"""Write-ahead log for the CF serving path (a copy of
``repro.serving.wal``, which the port may not import; the byte format is
the same, so either package reads the other's log).

The paper's economics make arena state precious: a similarity list is
cheap to *maintain* (TwinSearch copy, incremental updates, rotation's
pure data movement) but expensive to *rebuild* (the traditional O(n²m)
scan).  A crash between snapshots therefore must not cost more than a
replay of the operations since the last snapshot — never a similarity
recompute.  This log makes that true:

  * every mutating operation (``onboard`` / ``add_rating`` / ``rotate``)
    is appended **before** it is applied, as a length-prefixed,
    CRC32-checksummed record (optionally fsync'd) carrying everything
    replay needs to reproduce the op bit-exactly — the validated rating
    payload, the effective onboarding path (twinsearch vs traditional),
    and the drawn probe rows;
  * on restart, records with sequence numbers past the newest durable
    checkpoint replay on top of it through the same ops, so the
    recovered arena is bit-identical to the pre-crash one;
  * a torn tail (the record being written when the process died) fails
    its length/CRC check and is truncated on open — a crash mid-append
    never corrupts the log, it just loses the in-flight record;
  * truncation is tied to the snapshot cadence: a durable checkpoint at
    sequence S drops every record with seq <= S (``truncate_through``),
    and a rollback to the snapshot at S drops every record with seq > S
    (``truncate_after``) so the log always equals "ops since the state
    the next recovery would start from".

Record payload layout: one JSON line (seq, op, scalar fields, array
manifest) followed by the raw little-endian bytes of each array.  Arrays
round-trip exactly — no text encoding of floats anywhere.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

MAGIC = b"CFWAL1\n"
_HDR = struct.Struct("<II")            # (payload length, payload crc32)
WAL_FILE = "wal.log"


@dataclass(frozen=True)
class WalRecord:
    seq: int
    op: str                            # "onboard" | "add_rating" | "rotate" | "abort"
    fields: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)   # name -> np.ndarray


def _encode(rec: WalRecord) -> bytes:
    manifest = []
    blobs = []
    for name, arr in rec.arrays.items():
        a = np.ascontiguousarray(arr)
        manifest.append([name, str(a.dtype), list(a.shape)])
        blobs.append(a.tobytes())
    meta = json.dumps({"seq": rec.seq, "op": rec.op, "fields": rec.fields,
                       "arrays": manifest}).encode()
    return meta + b"\n" + b"".join(blobs)


def _decode(payload: bytes) -> WalRecord:
    nl = payload.index(b"\n")
    meta = json.loads(payload[:nl].decode())
    arrays = {}
    off = nl + 1
    for name, dtype, shape in meta["arrays"]:
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) if shape else 1
        nbytes = n * dt.itemsize
        arrays[name] = np.frombuffer(
            payload[off:off + nbytes], dtype=dt).reshape(shape).copy()
        off += nbytes
    return WalRecord(seq=int(meta["seq"]), op=meta["op"],
                     fields=meta["fields"], arrays=arrays)


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so a rename survives power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:                     # not supported on this platform/fs
        pass


class WriteAheadLog:
    """Single append-only segment under ``wal_dir`` with torn-tail repair.

    ``fsync=True`` (the default) makes each append durable before the
    operation it logs is applied; ``fsync=False`` trades the crash-window
    of one OS buffer flush for append latency.

    ``first_seq``/``last_seq`` are the *raw* sequence bounds of the log —
    they count every intact record, including aborted ops and their
    ``abort`` compensation records that ``records()`` filters out of the
    replay stream.  Recovery leans on that distinction twice: an aborted
    prefix is not a *missing* prefix, and a sequence number consumed by an
    aborted tail must never be reissued (``records()`` would drop the new
    record as aborted on the next recovery).  ``last_seq`` rewinds to the
    rollback point on ``truncate_after`` and is unchanged by
    ``truncate_through`` (dropping a checkpointed prefix un-consumes
    nothing).
    """

    def __init__(self, wal_dir: str, *, fsync: bool = True):
        os.makedirs(wal_dir, exist_ok=True)
        self.dir = wal_dir
        self.path = os.path.join(wal_dir, WAL_FILE)
        self.fsync = bool(fsync)
        self.appended = 0
        self.truncations = 0
        self.syncs = 0                     # actual write+fsync round-trips
        self._batch_depth = 0
        self._pending: list[bytes] = []    # encoded frames awaiting flush
        if not os.path.exists(self.path):
            with open(self.path, "wb") as f:
                f.write(MAGIC)
                f.flush()
                os.fsync(f.fileno())
            _fsync_dir(wal_dir)
        self.first_seq, self.last_seq, self._n_records = self._repair_tail()
        self._f = open(self.path, "ab")

    # -- scan / repair ------------------------------------------------------

    def _scan(self) -> tuple[list[WalRecord], int]:
        """All intact records + the byte offset where intact data ends."""
        records: list[WalRecord] = []
        with open(self.path, "rb") as f:
            head = f.read(len(MAGIC))
            if head != MAGIC:
                log.error("WAL %s has a bad magic header; treating as empty",
                          self.path)
                return [], len(MAGIC)
            good_end = f.tell()
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    break                        # clean EOF or torn header
                length, crc = _HDR.unpack(hdr)
                payload = f.read(length)
                if len(payload) < length or zlib.crc32(payload) != crc:
                    break                        # torn/corrupt tail record
                try:
                    records.append(_decode(payload))
                except Exception:                # undecodable despite CRC
                    break
                good_end = f.tell()
        return records, good_end

    def _repair_tail(self) -> tuple[int, int, int]:
        records, good_end = self._scan()
        size = os.path.getsize(self.path)
        if good_end < size:
            log.warning("WAL %s: truncating torn tail (%d -> %d bytes)",
                        self.path, size, good_end)
            with open(self.path, "r+b") as f:
                f.truncate(good_end)
                f.flush()
                os.fsync(f.fileno())
        first = records[0].seq if records else 0
        last = records[-1].seq if records else 0
        return first, last, len(records)

    # -- append / read ------------------------------------------------------

    def append(self, seq: int, op: str, fields: dict | None = None,
               arrays: dict | None = None) -> None:
        payload = _encode(WalRecord(seq=seq, op=op, fields=fields or {},
                                    arrays=arrays or {}))
        frame = _HDR.pack(len(payload), zlib.crc32(payload)) + payload
        if self._batch_depth > 0:
            self._pending.append(frame)
        else:
            self._f.write(frame)
            self._f.flush()
            if self.fsync:
                os.fsync(self._f.fileno())
            self.syncs += 1
        if self._n_records == 0:
            self.first_seq = seq
        self.last_seq = seq
        self._n_records += 1
        self.appended += 1

    # -- group commit -------------------------------------------------------

    def flush(self) -> None:
        """Write every buffered frame in one write + (optional) fsync.

        Durability granularity under a batch is the batch: a crash before
        flush loses the *whole* pending group, never a prefix of committed
        records followed by a gap — the frames hit the file in one
        contiguous write, and a torn write truncates from the tear."""
        if not self._pending:
            return
        self._f.write(b"".join(self._pending))
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        self.syncs += 1
        self._pending.clear()

    @contextlib.contextmanager
    def batch(self):
        """Coalesce appends inside the block into a single flush at exit.

        Nests: only the outermost batch flushes.  Any read or truncation
        during the batch flushes first, so buffered records are never
        invisible to the log's own API."""
        self._batch_depth += 1
        try:
            yield self
        finally:
            self._batch_depth -= 1
            if self._batch_depth == 0:
                self.flush()

    def records(self, after_seq: int = 0) -> list[WalRecord]:
        """Intact records with seq > ``after_seq``, in append order,
        with aborted operations (compensation records) filtered out."""
        self.flush()
        recs, _ = self._scan()
        aborted = {r.fields.get("target") for r in recs if r.op == "abort"}
        return [r for r in recs
                if r.seq > after_seq and r.op != "abort"
                and r.seq not in aborted]

    def __len__(self) -> int:
        return self._n_records

    def size_bytes(self) -> int:
        self.flush()
        return os.path.getsize(self.path)

    # -- truncation ---------------------------------------------------------

    def truncate_through(self, seq: int) -> None:
        """Drop records with seq <= ``seq`` — a durable checkpoint at
        ``seq`` has subsumed them.  ``last_seq`` is unchanged: dropping a
        checkpointed prefix un-consumes no sequence numbers."""
        self._rewrite(lambda r: r.seq > seq, last_seq=self.last_seq)

    def truncate_after(self, seq: int) -> None:
        """Drop records with seq > ``seq`` — a rollback discarded their
        effects.  ``last_seq`` rewinds to ``seq`` (even when every record
        is dropped) so the discarded sequence numbers are reissued, in
        lockstep with the server's own counter."""
        self._rewrite(lambda r: r.seq <= seq,
                      last_seq=min(self.last_seq, seq))

    def _rewrite(self, keep, *, last_seq: int) -> None:
        self.flush()
        recs, _ = self._scan()
        kept = [r for r in recs if keep(r)]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(MAGIC)
            for r in kept:
                payload = _encode(r)
                f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
                f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)               # atomic publish
        _fsync_dir(self.dir)
        self._f = open(self.path, "ab")
        self._n_records = len(kept)
        self.first_seq = kept[0].seq if kept else 0
        self.last_seq = last_seq
        self.truncations += 1

    def close(self) -> None:
        try:
            self.flush()
        except Exception:
            pass
        try:
            self._f.close()
        except Exception:
            pass
