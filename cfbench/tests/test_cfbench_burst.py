"""The burst cell (``douban-item-burst``: kind ``burst``, the item-mode
configuration) at a tiny size on the CPU: a sound run is correct and
each planted fault is not; its readers; its configuration by
arithmetic; and, on the card, its TF32 control at the cell's own size."""
import copy
import json

import pytest
import torch

from cfbench.bench import HERE, ROOT, load_cell, read_metric
from cfbench.run import run_cell
from cfbench.tests.test_cfbench_imports import imported

CELL = "douban-item-burst"
TINY_BURST = {"config": {"n_users": 300, "n_items": 96, "n_ratings": 6000},
              "mix": {"rate_per_s": 20.0, "pool_size": 8,
                      "pool_min_ratings": 20, "fresh_raters": 8}}
READERS = ("burst.service_p50_ms", "burst.search_p50_ms",
           "burst.fallback.roofline_share", "twinsearch.burst_twin_share",
           "device.idle_share.burst")


def run(seed=77, trace=False):
    cell = load_cell(CELL, overrides=copy.deepcopy(TINY_BURST))
    result, _, checks = run_cell(cell, seed, 1.0, trace, "cpu")
    return result, {c.name: c for c in checks}


def planted(monkeypatch, fault):
    """Wrap the burst so that ``fault(vals, idx, stats, n_base)`` alters
    what it returns."""
    from repro_torch.core import twinsearch as ts
    sound = ts.onboard_batch_buffered

    def step(state, R_new, probes, **kw):
        vals, idx, stats = sound(state, R_new, probes, **kw)
        return fault(vals, idx, stats, state.capacity)

    monkeypatch.setattr(ts, "onboard_batch_buffered", step)


def test_sound_run_is_correct():
    result, checks = run()
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(checks) == {"sim_gap", "list_id_rows", "unsorted_rows",
                           "twin_flag_errors", "twin_copy_errors",
                           "geometry_errors"}


def test_later_rows_skip_the_copy(monkeypatch):
    """Rows that twin an earlier row of the burst keep no base entries."""
    def skip(vals, idx, stats, n_base):
        k, W = vals.shape
        u = torch.full((k, W), -2.0)
        u.scatter_(1, idx.long(), vals)
        later = stats.found & (stats.twin_idx >= n_base)
        u[later, :n_base] = -2.0
        v, i = torch.sort(u, dim=1, stable=True)
        return v, i.to(torch.int32), stats

    planted(monkeypatch, skip)
    result, checks = run()
    assert not result["correct"]
    assert not checks["list_id_rows"].ok
    assert not checks["twin_copy_errors"].ok


def test_list_value_off_by_1e_3(monkeypatch):
    def off(vals, idx, stats, n_base):
        vals = vals.clone()
        vals[:, -1] += 1e-3
        return vals, idx, stats

    planted(monkeypatch, off)
    result, checks = run()
    assert not result["correct"]
    assert not checks["sim_gap"].ok


def test_one_twin_flag_flipped(monkeypatch):
    flipped = []

    def flip(vals, idx, stats, n_base):
        if not flipped and stats.found.numel() > 1:
            found = stats.found.clone()
            found[-1] = ~found[-1]
            stats = stats._replace(found=found)
            flipped.append(True)
        return vals, idx, stats

    planted(monkeypatch, flip)
    result, checks = run()
    assert flipped and not result["correct"]
    assert checks["twin_flag_errors"].value == 1


def test_readers_read_the_burst_cell_only():
    result, _ = run(seed=5300000199, trace=True)
    got = result["metrics"]
    for name in ("burst.service_p50_ms", "burst.search_p50_ms",
                 "twinsearch.burst_twin_share"):
        assert got[name]["value"] > 0, name
    # No device time on the CPU: the device readers read nothing.
    assert "burst.fallback.roofline_share" not in got
    assert "device.idle_share.burst" not in got
    onboard = {"kind": "onboard", "requests": [], "stats": {}}
    assert all(read_metric(n, onboard) is None for n in READERS)


def test_fallback_roofline_share_arithmetic(monkeypatch):
    from cfbench.metrics import _burst
    from cfbench.roofline_burst import fallback_bound_s

    class Entry:
        def __init__(self, dev):
            self.dev = dev

        def rows(self, name):
            return ([["burst.fallback", -1, 0, 0, d] for d in self.dev]
                    if name == "burst.fallback" else [])

    entries = [Entry([9_000_000]), Entry([]), Entry([11_000_000])]
    monkeypatch.setattr(_burst, "window_entries", lambda records: entries)
    records = {"kind": "onboard", "bursts": [{}], "arena": [58541, 129490]}
    got = read_metric("burst.fallback.roofline_share", records)
    assert got == pytest.approx(100 * fallback_bound_s(58541, 129490)
                                / 0.010)
    assert 90 < got < 91


def test_item_config_sizes_by_arithmetic():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in bench["configs"]}["douban-item-58k"]
    cfg = json.loads((ROOT / entry["file"]).read_text())
    pub = cfg["published"]
    assert cfg["mode"] == "item" and entry["reduced"] == [] \
        and cfg["reduced"] == {}
    assert all(cfg[k] == pub[k] for k in pub)
    n, m = cfg["n_items"], cfg["n_users"]           # rows, columns
    mem = cfg["memory"]
    assert (mem["rows"], mem["columns"]) == (n, m)
    assert mem["ratings_bytes"] == 4 * n * m
    assert mem["lists_bytes"] == 8 * n * n
    assert mem["arena_bytes"] == 4 * n * m + 8 * n * n + 4 * n
    from repro_torch.configs.base import CFConfig
    fields = {f.name for f in __import__("dataclasses").fields(CFConfig)}
    assert set(cfg["burst"]) <= fields


def test_reference_burst_imports_nothing_of_the_program():
    got = imported(HERE / "reference_burst.py") | imported(
        HERE / "roofline_burst.py")
    assert not got & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


@pytest.mark.gpu
def test_tf32_control_fails_at_the_cells_size(cuda_device):
    from cfbench.control import readings
    r = readings(CELL, [5290000301, 5290000302, 5290000303], 10.0, "cuda")
    limits = r["limits"]
    assert all(r["lower"][k] <= limits[k] for k in limits), r
    assert r["upper"]["sim_gap"] > limits["sim_gap"], r
