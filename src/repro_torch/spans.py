"""In-memory spans of the port's requests, on the profiler's clock.

A request entry point (``CFServer.onboard_user``, ``recommend_batch``,
``models.cf.build_step``, ...) opens ``RECORDER.request(name)``: one
entry of the log, with an id that grows by one a request.  Inside it,
``RECORDER.span(name)`` opens a child of the innermost open span and
records that parent, so each span names the span that caused it.  A span
opened while no request is open records nothing and only times itself
(its ``ms``, as every span has), so direct calls (a kernel timed alone, a
test calling a core function) are not perturbed and a caller that reads
the span's time works on every path.

Each entry holds its id and name, its start and end in Unix ns and its
children as ``[name, parent, start, end, device_ns]`` rows in the order
they opened (``parent`` is the row of the enclosing span, -1 for the
request itself).  Starts and ends are ``perf_counter_ns`` readings moved
by one ``(perf_counter_ns, time_ns)`` anchor taken at import, so they lie
on the clock that the PyTorch profiler stamps its events with and can be
placed against a device trace.  ``breakdown`` sums a list of entries by
name: host time, self time (a span's duration minus what its direct
children cover) and device time.

``span(name, device=True)`` (or a CUDA stream) also records a pair of
CUDA events around the span, on the current stream (looked up at the
request's first device span) or the one given.  The pairs come from a pool
of ``EVENT_PAIRS`` made at the first device span; nothing waits on them
or asks after them while the program runs.  They are read when the log
is read (``entries``, ``resolve``), after the reader's own sync, which
fills ``device_ns``.  A device span that finds the pool empty takes the
oldest pair still unread, and that span's device time is lost
(``device_lost``).  On the CPU nothing is recorded on the device and
``device_ns`` stays None.

Bounded: the log keeps the last ``LOG_ENTRIES`` = 8,192 requests (above
the densest benchmark window, 90 onboards/s x 51 s), and counts what fell
off in ``dropped``.

Nothing here reaches the PyTorch profiler or waits for the device: no
range is opened on the profiler's timeline, so a profiled run's device
timeline holds the device's own operations only.  One process-wide
``RECORDER``; ``clear`` empties it (tests).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from itertools import count

LOG_ENTRIES = 8192
EVENT_PAIRS = 4096

_perf_ns = time.perf_counter_ns


def _anchor() -> int:
    """Unix ns minus ``perf_counter_ns`` at import, read between two
    ``perf_counter_ns`` readings."""
    a = _perf_ns()
    unix = time.time_ns()
    b = _perf_ns()
    return unix - (a + b) // 2


OFFSET_NS = _anchor()       # perf_counter_ns + OFFSET_NS = Unix ns


class Entry:
    """One request: ``id``, ``name``, ``start`` and ``end`` (Unix ns) and
    its ``children`` rows ``[name, parent, start, end, device_ns]``."""

    __slots__ = ("id", "name", "start", "end", "children", "stack",
                 "stream")

    def __init__(self, id_: int, name: str):
        self.id = id_
        self.name = name
        self.start = self.end = 0
        self.children: list[list] = []
        self.stack = [-1]       # the open rows while it is open (-1: itself)
        self.stream = None      # the current stream, at its first device span

    @property
    def host_ns(self) -> int:
        return self.end - self.start

    def rows(self, name: str) -> list[list]:
        """The children named ``name``, in the order they opened."""
        return [c for c in self.children if c[0] == name]

    def host_ns_of(self, name: str) -> int:
        """Summed host ns of the children named ``name``."""
        return sum(c[3] - c[2] for c in self.children if c[0] == name)

    def device_ns_of(self, name: str) -> int | None:
        """Summed device ns of the children named ``name``; None if one of
        them has no device reading (the CPU, or a lost one)."""
        total = 0
        for c in self.children:
            if c[0] == name:
                if c[4] is None:
                    return None
                total += c[4]
        return total


class _Timer:
    """What ``span`` returns outside a request: it records nothing; its
    ``t0`` (``perf_counter_ns``) is set when it opens and ``ns`` when it
    closes."""

    __slots__ = ("t0", "ns")

    @property
    def ms(self) -> float:
        return self.ns * 1e-6

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self.ns = _perf_ns() - self.t0
        return False


class _Span(_Timer):
    """An open child span (``Recorder.span`` opens it), which writes its
    row's start and end when it closes."""

    __slots__ = ("stack", "row", "pair", "stream", "pending")

    def __exit__(self, *exc) -> bool:
        t1 = _perf_ns()
        if self.pair is not None:
            self.pair[1].record(self.stream)
            self.pending.append((self.row, self.pair))
        self.stack.pop()
        t0 = self.t0
        self.ns = t1 - t0
        row = self.row
        row[2] = t0 + OFFSET_NS
        row[3] = t1 + OFFSET_NS
        return False


class _Request:
    """An open request.  One opened inside another is an entry of its own,
    and the spans opened while it is open are its children."""

    __slots__ = ("rec", "name", "entry", "outer", "t0", "ns")

    def __init__(self, rec: "Recorder", name: str):
        self.rec = rec
        self.name = name

    @property
    def ms(self) -> float:
        return self.ns * 1e-6

    def __enter__(self):
        loc = self.rec._local
        self.outer = loc.entry
        self.entry = loc.entry = Entry(next(self.rec._ids), self.name)
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = _perf_ns()
        self.rec._local.entry = self.outer
        self.ns = t1 - self.t0
        self.entry.start = self.t0 + OFFSET_NS
        self.entry.end = t1 + OFFSET_NS
        self.rec._close(self.entry)
        return False


class _Local(threading.local):
    def __init__(self):
        self.entry: Entry | None = None     # the innermost open request


class Recorder:
    """The log of requests; see the module docstring."""

    def __init__(self, log_entries: int = LOG_ENTRIES,
                 event_pairs: int = EVENT_PAIRS):
        self.log: deque[Entry] = deque(maxlen=log_entries)
        self.dropped = 0
        self.device_lost = 0
        self.event_pairs = event_pairs
        self._local = _Local()
        self._lock = threading.Lock()
        self._ids = count()
        self._pool: list | None = None
        self._cuda = None                   # torch.cuda, with the pool
        self._pending: deque = deque()      # (row, pair) not yet read

    # -- the hot path -------------------------------------------------------

    def request(self, name: str) -> _Request:
        """A context manager for one call of a request entry point."""
        return _Request(self, name)

    def span(self, name: str, device=False):
        """A context manager for a child of the innermost open span, open
        from this call on.  ``device``: True records CUDA events on the
        stream current at the request's first device span (looked up once
        a request), a stream records them on that stream."""
        entry = self._local.entry
        if entry is None:
            t = _Timer()
            t.t0 = _perf_ns()
            return t
        s = _Span()
        stack = entry.stack
        children = entry.children
        row = [name, stack[-1], 0, 0, None]
        stack.append(len(children))
        children.append(row)
        s.stack = stack
        s.row = row
        if device:
            s.pending = self._pending
            s.pair = self._take_pair()
            if device is True:
                if entry.stream is None:
                    entry.stream = self._cuda.current_stream()
                device = entry.stream
            s.stream = device
            s.pair[0].record(device)
        else:
            s.pair = None
        s.t0 = _perf_ns()
        return s

    def _take_pair(self):
        if self._pool is None:
            import torch
            self._cuda = torch.cuda
            self._pool = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(self.event_pairs)]
        if self._pool:
            return self._pool.pop()
        _, pair = self._pending.popleft()
        self.device_lost += 1
        return pair

    def _close(self, entry: Entry) -> None:
        with self._lock:
            if len(self.log) == self.log.maxlen:
                self.dropped += 1
            self.log.append(entry)

    # -- reading ------------------------------------------------------------

    def resolve(self) -> int:
        """Fill ``device_ns`` of every device span whose events the device
        has passed, and return their pairs to the pool; returns how many
        remain unread.  Call after a sync."""
        with self._lock:
            pending, keep = self._pending, []
            for _ in range(len(pending)):
                row, pair = pending.popleft()
                if keep or not pair[1].query():
                    keep.append((row, pair))
                    continue
                row[4] = int(round(pair[0].elapsed_time(pair[1]) * 1e6))
                self._pool.append(pair)
            pending.extendleft(reversed(keep))      # in place: open spans
            return len(keep)                        # hold this deque

    def entries(self, name: str | None = None) -> list[Entry]:
        """The log's entries (of request ``name``), oldest first, with
        their device spans resolved as far as the device has run."""
        if self._pending:
            self.resolve()
        with self._lock:
            log = list(self.log)
        return log if name is None else [e for e in log if e.name == name]

    def clear(self) -> None:
        """Empty the log and the counters (unread device spans are dropped
        and their pairs returned to the pool)."""
        with self._lock:
            self.log.clear()
            self.dropped = self.device_lost = 0
            while self._pending:
                self._pool.append(self._pending.popleft()[1])


def _fold(entry: Entry, into: dict[str, list[int]]) -> None:
    """Add ``entry`` and its children to the per-name sums ``into``:
    ``[count, host_ns, self_ns, device_ns]``."""
    children = entry.children
    covered = [0] * len(children)
    own = 0
    for c in children:
        if c[1] < 0:
            own += c[3] - c[2]
        else:
            covered[c[1]] += c[3] - c[2]
    rows = [(entry.name, entry.host_ns, entry.host_ns - own, None)]
    rows += [(c[0], c[3] - c[2], c[3] - c[2] - cov, c[4])
             for c, cov in zip(children, covered)]
    for name, dur, own_ns, dev in rows:
        t = into.get(name)
        if t is None:
            t = into[name] = [0, 0, 0, 0]
        t[0] += 1
        t[1] += dur
        t[2] += own_ns
        if dev is not None:
            t[3] += dev


RECORDER = Recorder()


def breakdown(entries: list[Entry]) -> dict[str, dict[str, float | None]]:
    """Per request or span name over ``entries``: how many a request, and
    the host, self and device ms a request (device None where no span of
    the name has a device reading)."""
    totals: dict[str, list[int]] = {}
    for e in entries:
        _fold(e, totals)
    n = max(1, len(entries))
    return {name: {"per_request": c / n, "host_ms": host * 1e-6 / n,
                   "self_ms": own * 1e-6 / n,
                   "device_ms": dev * 1e-6 / n if dev else None}
            for name, (c, host, own, dev) in totals.items()}
