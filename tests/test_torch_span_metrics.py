"""The benchmark's readers of the port's spans (``cfbench/metrics``, the
``program_span`` metrics that read ``repro_torch.spans.RECORDER``): each
cell kind run at the benchmark's tiny size on the CPU, and the readers'
arithmetic on planted entries where only the card has device time."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from cfbench.bench import Ctx, load_cell, read_metric
from cfbench.roofline import build_bound_s
from cfbench.tests.conftest import TINY
from cfbench.trace import Tracer
from repro_torch.spans import RECORDER, Entry

torch.set_num_threads(2)

READERS = {"onboard": ("health.sweep_ms", "twinsearch.search_p50_ms"),
           "read": ("dedup.hash_p50_ms", "dedup.keys_p50_ms")}
DEVICE_READERS = {"onboard": "rotation.merge_ms",
                  "build": "similarity.roofline_share"}
ALL = ("health.sweep_ms", "rotation.merge_ms", "twinsearch.search_p50_ms",
       "dedup.hash_p50_ms", "dedup.keys_p50_ms",
       "similarity.roofline_share")
CELLS = {"onboard": "douban-onboard", "read": "douban-read",
         "build": "douban-build"}


def _window(kind: str, seconds: float = 1.0):
    """Set-up and window of the kind's cell at the tiny size on the CPU,
    as ``cfbench.run.run_cell`` runs them, untraced; returns the records
    and the driver's state (the server still alive)."""
    cell = load_cell(CELLS[kind], overrides=copy.deepcopy(TINY))
    ctx = Ctx(cell, 5300000177, seconds, False, torch.device("cpu"))
    tracer = Tracer(False, ctx.device)
    st = cell.driver.setup(ctx, tracer)
    records = cell.driver.window(ctx, st, tracer)
    records["traced_from_s"] = None
    return records, st


@pytest.fixture(scope="module")
def runs():
    """Each kind's records, and every reader's value read right after its
    window (as a benchmark run reads them: one kind a process)."""
    out = {}
    for kind in ("onboard", "read", "build"):
        records, _ = _window(kind)
        out[kind] = records, {name: read_metric(name, records)
                              for name in ALL}
    return out


@pytest.mark.parametrize("kind", ["onboard", "read", "build"])
def test_each_reader_reads_its_own_kind_only(runs, kind):
    _, got = runs[kind]
    for name in READERS.get(kind, ()):
        assert got[name] is not None and got[name] > 0, name
    # No device time on the CPU: the device readers read nothing.
    for name in ALL:
        if name not in READERS.get(kind, ()):
            assert got[name] is None, name


@pytest.mark.parametrize("kind", ["onboard", "read"])
def test_a_shifted_log_reads_nothing(kind):
    RECORDER.clear()
    records, st = _window(kind, seconds=0.5)
    name = READERS[kind][0]
    assert read_metric(name, records) is not None
    srv = st["srv"]
    time.sleep(0.005)
    if kind == "onboard":
        srv.onboard_user(st["traffic"].payload(st["traffic"].plans[
            "window"][0]))
    else:
        srv.recommend_batch(st["batches"][0], n=10, k_neighbors=20)
    assert read_metric(name, records) is None
    RECORDER.clear()
    assert read_metric(name, records) is None


def test_a_log_missing_its_oldest_entries_reads_nothing():
    RECORDER.clear()
    records, _ = _window("read", seconds=0.5)
    saved = list(RECORDER.log)
    try:
        RECORDER.log.clear()
        RECORDER.log.extend(saved[len(saved) // 2:])   # the oldest dropped
        assert read_metric("dedup.hash_p50_ms", records) is None
    finally:
        RECORDER.log.clear()
        RECORDER.log.extend(saved)
    assert read_metric("dedup.hash_p50_ms", records) is not None


def test_without_the_recorder_nothing_is_read(runs, monkeypatch):
    import sys
    monkeypatch.delitem(sys.modules, "repro_torch.spans")
    for kind in ("onboard", "read", "build"):
        records, _ = runs[kind]
        for name in ALL:
            assert read_metric(name, records) is None


# -- planted entries ----------------------------------------------------------

def _plant(name, intervals_ms, children):
    """Entries of request ``name`` at the given (start, end) ms of a window
    starting at 1e12 ns, with children rows ``[name, parent, start, end,
    device_ns]`` given as (name, offset_ms, length_ms, device_ns)."""
    base = 10 ** 12
    RECORDER.clear()
    out = []
    for i, ((a, b), kids) in enumerate(zip(intervals_ms, children)):
        e = Entry(i, name)
        e.start = base + round(a * 1e6) + 5_000
        e.end = base + round(b * 1e6) - 5_000
        for kid, off, length, dev in kids:
            s = e.start + round(off * 1e6)
            e.children.append([kid, -1, s, s + round(length * 1e6), dev])
        RECORDER.log.append(e)
        out.append(e)
    return out


def test_similarity_roofline_share_arithmetic():
    n, m = 32_768, 58_541
    ends = [400.0, 800.0, 1200.0, 1600.0]
    dev = [266_000_000, 268_000_000, 264_000_000, 270_000_000]
    _plant("cf.build_step", list(zip([0.0] + ends[:-1], ends)),
           [[("kernel.similarity", 1.0, 300.0, d)] for d in dev])
    records = {"kind": "build", "ends": [t * 1e-3 for t in ends],
               "builds": 4, "n": n, "m": m, "traced_from_s": 1.3}
    got = read_metric("similarity.roofline_share", records)
    want = 100.0 * build_bound_s(n, m) / (sum(dev[:3]) / 3 * 1e-9)
    assert got == pytest.approx(want, rel=1e-12)
    assert 40.0 < got < 50.0
    records["traced_from_s"] = None
    assert read_metric("similarity.roofline_share", records) == \
        pytest.approx(100.0 * build_bound_s(n, m) / (sum(dev) / 4 * 1e-9))
    # A build of the same length 0.1 s after the window shifts the log:
    # nothing is read.
    e = Entry(9, "cf.build_step")
    e.start = 10 ** 12 + 1_700_005_000
    e.end = 10 ** 12 + 2_099_995_000
    e.children.append(["kernel.similarity", -1, e.start, e.end, dev[0]])
    RECORDER.log.append(e)
    assert read_metric("similarity.roofline_share", records) is None


def test_rotation_merge_ms_arithmetic():
    intervals = [(0.0, 5.0), (10.0, 250.0), (260.0, 265.0), (270.0, 480.0)]
    kids = [[("twinsearch.search", 1.0, 1.0, None)],
            [("rotation.merge", 1.0, 20.0, 15_000_000),
             ("rotation.merge", 22.0, 20.0, 17_000_000)],
            [("twinsearch.search", 1.0, 2.0, None)],
            [("rotation.merge", 1.0, 20.0, 16_000_000),
             ("rotation.merge", 22.0, 20.0, 14_000_000)]]
    _plant("cf_server.onboard_user", intervals, kids)
    records = {"kind": "onboard", "traced_from_s": None,
               "requests": [{"due": a * 1e-3, "start": a * 1e-3,
                             "end": b * 1e-3} for a, b in intervals]}
    assert read_metric("rotation.merge_ms", records) == pytest.approx(31.0)
    assert read_metric("twinsearch.search_p50_ms", records) == \
        pytest.approx(1.5)
    records["traced_from_s"] = 0.2          # the last two under the profiler
    assert read_metric("rotation.merge_ms", records) == pytest.approx(32.0)
    # A device reading lost or absent: nothing is read.
    RECORDER.log[1].children[0][4] = None
    assert read_metric("rotation.merge_ms", records) is None
    # An entry longer than its call by over 1 ms: nothing is read.
    RECORDER.log[1].children[0][4] = 15_000_000
    RECORDER.log[2].end += 2_000_000
    assert read_metric("rotation.merge_ms", records) is None
