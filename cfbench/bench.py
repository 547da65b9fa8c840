"""Finding a cell's files by name, and what drivers and readers share.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
mix names its kind.  ``load_cell`` reads the three and finds the driver
and the metric readers, so a new cell, configuration, kind or metric is a
new file and a new entry, never an edit here.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that must never be loaded by a run: the JAX
# stack and the JAX package the port was made from.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files loaded."""
    name: str
    chips: int
    config: dict
    mix: dict
    driver: Any
    end_to_end: list[dict]
    per_layer: list[dict]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, *, overrides: dict | None = None,
              spec: dict | None = None) -> Cell:
    """The cell ``name``: its configuration file, its mix
    (``cfbench/mixes/<traffic>.json``), its driver
    (``cfbench/drivers/<kind>.py``) and the metrics that apply to it.
    ``spec`` (``config``, ``traffic``, ``chips``) stands for a cell that
    ``BENCHMARK.json`` does not list; ``overrides`` replaces keys of the
    configuration (``"config"``) and the mix (``"mix"``), for tests at a
    small size."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if spec is None and name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = spec or cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / cfg_entry["file"])
    mix = load_json(HERE / "mixes" / f"{w['traffic']}.json")
    overrides = overrides or {}
    config.update(overrides.get("config", {}))
    mix.update(overrides.get("mix", {}))
    driver = load_module(HERE / "drivers" / f"{mix['kind']}.py",
                         f"cfbench_driver_{mix['kind']}")
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                driver=driver,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def read_metric(name: str, records: dict):
    """The metric ``name`` from a run's records, by its reader
    ``cfbench/metrics/<name>.py``; None when the reader finds nothing."""
    mod = load_module(HERE / "metrics" / f"{name}.py",
                      "cfbench_metric_" + name.replace(".", "_"))
    value = mod.read(records)
    return None if value is None else float(value)


@dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name} {self.value!r} <= {self.limit!r} "
                f"{'ok' if self.ok else 'FAILED'}")


@dataclass
class Ctx:
    """What a driver is given: the cell, the seed, the window and where
    to run."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any
    notes: list = field(default_factory=list)
    t_lap: float = field(default_factory=time.perf_counter)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def mix(self) -> dict:
        return self.cell.mix

    def note(self, msg: str) -> None:
        """A line for standard error, printed before the checks."""
        self.notes.append(msg)

    def lap(self, what: str) -> None:
        """Note the seconds since the previous lap (set-up's parts), once
        the device has finished what was queued."""
        if getattr(self.device, "type", None) == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.note(f"set-up part: {what} {now - self.t_lap:.4f} s")
        self.t_lap = now


def untraced(records: dict) -> list:
    """The window's requests due before the profiler started (all of them
    in an untraced run): host-clock per-layer metrics read these, which
    the profiler does not slow."""
    start = records.get("traced_from_s")
    reqs = records["requests"]
    return reqs if start is None else [r for r in reqs if r["due"] < start]


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) with linear interpolation between
    order statistics (numpy's default rule); None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def derive_seed(seed: int, stream: int) -> int:
    """An independent generator seed for ``stream`` of a run's ``seed``
    (seeds may exceed 32 bits)."""
    return (int(seed) * 1_000_003 + int(stream) * 7_919) % (1 << 62)
