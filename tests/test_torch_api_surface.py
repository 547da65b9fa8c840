"""Port parity of the public surface: ``repro_torch.serving``,
``repro_torch.data``, ``repro_torch.distributed``, ``repro_torch.configs``,
``repro_torch.training`` and ``repro_torch.models`` against the
reference's snapshot in ``tests/test_api_surface.py``.

The port's ``serving.__all__`` is the reference's (``LMServer`` included);
the config, result and stats dataclasses have the reference's
field sets (``ServerStats`` may add timing fields); ``OnboardResult``
keeps the legacy ``(uid, info)`` protocol with the same answers as the
reference's.  ``data.__all__`` is the reference's (the recsys streams
landed with the recsys model), and its rating generators give the
reference's arrays for the same seed; ``distributed.__all__`` is the
reference's; ``configs.__all__``
and ``training.__all__`` are the reference's; ``models.__all__`` is the
reference's less the GNN family.  Importing the LM surface in a fresh
interpreter loads no module of ``jax`` or ``repro``.  A CPU server and the
reference's server onboard the same ratings through the legacy unpacking:
user ids, rungs, statuses and twin flags exact (a latency is a wall-clock
reading, so only its key mapping is held).  ``CFServer`` takes the
reference's flat keyword arguments with its ``DeprecationWarning`` and
refuses them beside a config, as the reference does.

The signature survey walks every module of ``repro`` (and its namespace
package ``repro.launch``) and every public function and class defined
there: the port has the module and the name, and a call written for the
reference is one the port accepts.  Every parameter (or dataclass /
NamedTuple field) of the reference is a parameter of the port, except the
JAX-only knobs of ``SURVEY_ALLOWED`` (the port dispatches by device, runs
eagerly, takes a process group or mesh where the reference takes mesh
axes or specs, and a ``torch.Generator`` ``gen`` for a ``jax.random``
``key``); every parameter the port adds has a default, or is the
``gen`` that replaces ``key``, or is one of ``SURVEY_REQUIRED``'s: the
port's ``launch.steps.Cell`` carries the spec and shape it was built from,
which ``jit_cell``'s trace rebuilds at global shapes, so a cell is made
by ``build_cell`` and not by hand.  ``SURVEY_NOT_PORTED`` names what is
still to be ported: nothing since the dry run.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import repro.data as jdata
import repro.serving as jserving
from repro.training.elastic import StragglerMonitor as JMonitor
import repro_torch.serving as serving
from repro_torch.training.elastic import StragglerMonitor
from tests.conftest import make_ratings

torch.set_num_threads(2)

NOT_PORTED: set[str] = set()
CONFIGS = ("ServerConfig", "SnapshotConfig", "WalConfig", "RotationConfig",
           "LadderConfig", "ReplicationConfig", "OnboardResult")


def _fields(cls) -> set[str]:
    return {f.name for f in dataclasses.fields(cls)}


def test_serving_all_is_the_reference_less_unported():
    assert set(serving.__all__) == set(jserving.__all__) - NOT_PORTED
    assert len(serving.__all__) == len(set(serving.__all__))


def test_every_serving_export_resolves():
    for name in serving.__all__:
        assert getattr(serving, name, None) is not None, name
    from repro_torch.distributed import ReplicationConfig
    assert serving.ReplicationConfig is ReplicationConfig


@pytest.mark.parametrize("name", CONFIGS)
def test_dataclass_fields_match_the_reference(name):
    assert _fields(getattr(serving, name)) == _fields(getattr(jserving,
                                                              name))


def test_server_stats_only_adds_fields():
    assert _fields(jserving.ServerStats) <= _fields(serving.ServerStats)
    jsummary = jserving.ServerStats().summary()
    assert set(jsummary) <= set(serving.ServerStats().summary())


def _results():
    kw = dict(user_id=7, status="ok", twin_found=True, latency_ms=1.5,
              rung="twinsearch")
    return jserving.OnboardResult(**kw), serving.OnboardResult(**kw)


@pytest.mark.parametrize("key", ["status", "twin_found", "ms", "level",
                                 "latency_ms", "rung", "user_id", 0,
                                 "retry_after_s", "reason"])
def test_result_legacy_getitem_matches_reference(key):
    jres, res = _results()
    got = res[key]
    want = jres[key]
    assert got == want and type(got) is type(want)


def test_result_legacy_shapes():
    """The reference's own cases (``test_result_legacy_shapes``) on the
    port's class."""
    res = serving.OnboardResult(user_id=7, status="ok", twin_found=True,
                                latency_ms=1.5, rung="twinsearch")
    uid, info = res                      # legacy tuple unpack
    assert uid == 7 and info is res
    assert res[0] == 7 and res[1] is res
    assert res["status"] == "ok"
    assert res["twin_found"] is True
    assert res["ms"] == 1.5              # legacy key -> latency_ms
    assert res["level"] == "twinsearch"  # legacy key -> rung
    assert res.get("retry_after_s", 0.0) == 0.0   # unset -> default
    assert "retry_after_s" not in res
    assert "status" in res
    with pytest.raises(KeyError):
        res["no_such_key"]
    assert res.ok


@pytest.mark.parametrize("key,default", [("retry_after_s", 0.0),
                                         ("ms", None), ("level", "x"),
                                         ("no_such_key", 3), ("reason", None),
                                         ("seq", 9)])
def test_result_get_and_contains_match_reference(key, default):
    jres, res = _results()
    assert res.get(key, default) == jres.get(key, default)
    assert res.get(key) == jres.get(key)
    assert (key in res) == (key in jres)
    assert list(res)[0] == list(jres)[0] == 7


@pytest.mark.parametrize("name,args", [
    ("synth_ratings", (3, 40, 25, 300)),
    ("movielens_100k", (5,)),
    ("douban_film", (2, 129_490, 58_541, 1 / 128)),
])
def test_data_exports_match_reference(name, args):
    from repro_torch import data
    assert name in data.__all__
    got = getattr(data, name)(*args)
    want = getattr(jdata, name)(*args)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_data_plant_twins_matches_reference():
    from repro_torch.data import (douban_film, movielens_100k, plant_twins,
                                  synth_ratings)
    assert callable(douban_film) and callable(movielens_100k)
    R = synth_ratings(1, 60, 30, 600)
    for src in (None, 4):
        got = plant_twins(R, 3, source_user=src, seed=11)
        want = jdata.plant_twins(R, 3, source_user=src, seed=11)
        assert np.array_equal(got, want)
    from repro_torch import data
    assert set(data.__all__) <= set(jdata.__all__)


# Every name of ``repro.data`` is ported (the recsys streams last).
DATA_NOT_PORTED: set[str] = set()
# Every name of ``repro.distributed`` is ported (the mesh names last).
DISTRIBUTED_NOT_PORTED: set[str] = set()
# Every model family is ported (the GNN family last).
MODELS_NOT_PORTED: set[str] = set()


def test_data_all_is_the_reference_less_recsys_streams():
    """No name is missing any more: the recsys streams are ported."""
    from repro_torch import data
    assert set(data.__all__) == set(jdata.__all__) - DATA_NOT_PORTED
    assert set(data.__all__) == set(jdata.__all__)
    assert len(data.__all__) == len(set(data.__all__))
    for name in data.__all__:
        assert getattr(data, name).__module__.startswith("repro_torch.")


def test_distributed_all_is_the_reference_less_mesh_names():
    """No name is missing any more: the mesh names are ported."""
    import repro.distributed as jdist
    import repro_torch.distributed as tdist
    assert set(tdist.__all__) == set(jdist.__all__) - DISTRIBUTED_NOT_PORTED
    assert tdist.__all__ == jdist.__all__
    for name in tdist.__all__:
        assert getattr(tdist, name).__module__.startswith("repro_torch.")


def test_distributed_exports_recsys_shardings():
    import repro_torch.distributed as tdist
    from repro_torch.distributed.sharding import (gnn_shardings,
                                                  lm_shardings,
                                                  recsys_shardings)
    assert "recsys_shardings" in tdist.__all__
    assert tdist.recsys_shardings is recsys_shardings
    assert "lm_shardings" in tdist.__all__
    assert tdist.lm_shardings is lm_shardings
    assert "gnn_shardings" in tdist.__all__
    assert tdist.gnn_shardings is gnn_shardings


def test_serving_exports_the_lm_server():
    from repro_torch.serving.lm_server import LMServer
    assert "LMServer" in serving.__all__ and serving.LMServer is LMServer
    assert set(serving.__all__) == set(jserving.__all__)


def test_the_lm_surface_loads_neither_jax_nor_the_reference():
    """A fresh interpreter with only ``src`` on its path imports the LM
    and GNN families' modules; ``sys.modules`` then holds no ``jax`` or
    ``repro`` module."""
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "from repro_torch.serving import LMServer\n"
            "from repro_torch.models import attention, moe, transformer\n"
            "from repro_torch.models import gnn, gnn_ep\n"
            "from repro_torch.distributed import gnn_shardings, lm_shardings\n"
            "from repro_torch.launch import serve, steps, train\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(root / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]


def test_training_all_is_the_reference():
    import repro.training as jtrain
    import repro_torch.training as ttrain
    assert ttrain.__all__ == jtrain.__all__
    for name in ttrain.__all__:
        obj = getattr(ttrain, name)            # ``checkpoint`` is a module
        mod = obj.__name__ if name == "checkpoint" else obj.__module__
        assert mod.startswith("repro_torch."), name


def test_models_all_is_the_reference_less_lm_and_gnn():
    """Since the GNN family landed, no model family is missing."""
    import repro.models as jmodels
    import repro_torch.models as tmodels
    assert set(tmodels.__all__) == set(jmodels.__all__) - MODELS_NOT_PORTED
    assert MODELS_NOT_PORTED <= set(jmodels.__all__)
    for name in tmodels.__all__:
        assert getattr(tmodels, name).__name__ == f"repro_torch.models.{name}"


def test_configs_all_is_the_reference():
    import repro.configs as jcfg
    import repro_torch.configs as tcfg
    assert tcfg.__all__ == jcfg.__all__
    for name in tcfg.__all__:
        assert getattr(tcfg, name).__module__.startswith("repro_torch.")


def _clock():
    ticks = itertools.count()
    return lambda: float(next(ticks))


def test_legacy_onboard_unpacking_matches_reference(rng):
    """``uid, info = srv.onboard_user(r)`` on the port's CPU server, twins
    and a fresh profile, against the reference's server on the same
    ratings (the port's probes are the ones the reference draws)."""
    R = make_ratings(rng, n=90, m=28)
    fresh = make_ratings(np.random.default_rng(42), n=1, m=28)[0]
    jsrv = jserving.CFServer(R, jserving.ServerConfig(
        capacity_extra=8, c_probes=4,
        ladder=jserving.LadderConfig(monitor=JMonitor(clock=_clock()))))
    srv = serving.CFServer(R, serving.ServerConfig(
        capacity_extra=8, c_probes=4,
        ladder=serving.LadderConfig(monitor=StragglerMonitor(
            clock=_clock()))), device="cpu")

    def jax_probes():
        _, sub = jax.random.split(jsrv._key)
        return torch.tensor(np.asarray(jax.random.randint(
            sub, (srv.c,), 0, srv.n_base)))

    srv._draw_probes = jax_probes
    for r in (R[11], R[11], fresh, fresh):
        uid, info = srv.onboard_user(r)
        juid, jinfo = jsrv.onboard_user(r)
        assert uid == juid == info["user_id"]
        assert info["level"] == jinfo["level"] == info.rung
        assert info["twin_found"] == jinfo["twin_found"]
        assert info["status"] == jinfo["status"] == "ok"
        assert info["ms"] == info.latency_ms > 0.0
        assert isinstance(jinfo["ms"], float)
    assert [srv.onboard_user(r)["twin_found"] for r in (R[3], fresh)] == \
        [jsrv.onboard_user(r)["twin_found"] for r in (R[3], fresh)]


# ---------------------------------------------------------------------------
# The signature survey
# ---------------------------------------------------------------------------

# JAX-only knobs the port may drop (``use_pallas``, ``interpret``: it
# dispatches by device; ``unroll``: it runs eagerly; ``rows_spec``,
# ``block_spec``, ``axes``: its collectives take a group or mesh; ``key``:
# it takes a ``torch.Generator``) or add (``device``).
SURVEY_ALLOWED = {"use_pallas", "interpret", "unroll", "rows_spec",
                  "block_spec", "axes", "key", "device"}
# The port's name for an allowed knob it replaces.
SURVEY_REPLACED = {"gen": "key"}
# Fields the port requires of one class, beside the reference's.
SURVEY_REQUIRED = {"launch.steps.Cell": {"spec", "shape"}}
# Still to be ported: none (the dry run, the roofline and ``jit_cell``
# were the last).
SURVEY_NOT_PORTED: set[str] = set()


def _survey_modules() -> list[str]:
    import pkgutil
    import repro
    names = [m.name.removeprefix("repro.") for m in pkgutil.walk_packages(
        repro.__path__, "repro.") if not m.name.split(".")[-1].startswith(
            "_")]
    launch = Path(repro.__path__[0]) / "launch"
    names += [f"launch.{p.stem}" for p in sorted(launch.glob("*.py"))
              if not p.stem.startswith("_")]
    return sorted(set(names))


def _params(obj):
    """(name -> has a default, or is *args/**kwargs) of a function or a
    class's fields or constructor."""
    import inspect
    if inspect.isclass(obj) and dataclasses.is_dataclass(obj):
        return {f.name: (f.default is not dataclasses.MISSING or
                         f.default_factory is not dataclasses.MISSING)
                for f in dataclasses.fields(obj) if f.init}
    if inspect.isclass(obj) and hasattr(obj, "_fields"):
        return {f: f in obj._field_defaults for f in obj._fields}
    try:
        sig = inspect.signature(obj)
    except (TypeError, ValueError):
        return None
    return {p.name: (p.default is not p.empty or p.kind in (
        p.VAR_POSITIONAL, p.VAR_KEYWORD)) for p in sig.parameters.values()}


@pytest.mark.parametrize("module", _survey_modules())
def test_signatures_match_the_reference(module):
    import importlib
    import inspect
    if module in SURVEY_NOT_PORTED:
        with pytest.raises(ImportError):
            importlib.import_module(f"repro_torch.{module}")
        return
    # ``repro.launch.dryrun`` sets XLA_FLAGS (512 host devices) when it is
    # imported; keep it from reaching later subprocesses of this worker.
    flags = os.environ.get("XLA_FLAGS")
    try:
        jmod = importlib.import_module(f"repro.{module}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    tmod = importlib.import_module(f"repro_torch.{module}")
    faults = []
    for name, obj in vars(jmod).items():
        if name.startswith("_") or not (inspect.isfunction(obj) or
                                        inspect.isclass(obj)):
            continue
        if obj.__module__ != jmod.__name__:
            continue
        if f"{module}.{name}" in SURVEY_NOT_PORTED:
            assert not hasattr(tmod, name), f"{name} is ported: update"
            continue
        tobj = getattr(tmod, name, None)
        if tobj is None:
            faults.append(f"{name}: missing")
            continue
        want, got = _params(obj), _params(tobj)
        if want is None or got is None:
            continue
        missing = set(want) - set(got) - SURVEY_ALLOWED
        added = {p for p, optional in got.items() if p not in want
                 and not optional and p not in SURVEY_ALLOWED
                 and SURVEY_REPLACED.get(p) not in want
                 and p not in SURVEY_REQUIRED.get(f"{module}.{name}", ())}
        if missing:
            faults.append(f"{name}: lacks {sorted(missing)}")
        if added:
            faults.append(f"{name}: requires {sorted(added)}")
    assert not faults, faults


def test_survey_covers_the_package():
    mods = _survey_modules()
    assert {"launch.mesh", "launch.steps", "models.moe_ep",
            "distributed.sharding", "serving.cf_server",
            "core.similarity"} <= set(mods)
    assert {"launch.roofline", "launch.dryrun"} <= set(mods)
    assert not SURVEY_NOT_PORTED


def test_cf_server_takes_legacy_keywords_with_a_warning():
    """The reference's flat keywords: the same server, the same warning;
    beside a config they raise ``ValueError`` in both packages."""
    R = make_ratings(np.random.default_rng(3), n=40, m=30)
    with pytest.warns(DeprecationWarning):
        jsrv = jserving.CFServer(R, capacity_extra=8, c_probes=4)
    with pytest.warns(DeprecationWarning, match="ServerConfig"):
        srv = serving.CFServer(R, capacity_extra=8, c_probes=4,
                               device="cpu")
    assert (srv.k_cap, srv.c) == (jsrv.k_cap, jsrv.c) == (8, 4)
    assert srv.config == serving.ServerConfig.from_kwargs(capacity_extra=8,
                                                          c_probes=4)
    for mod, kw in ((jserving, {}), (serving, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not both"):
            mod.CFServer(R, mod.ServerConfig(), capacity_extra=8, **kw)
    with pytest.warns(DeprecationWarning), \
            pytest.raises(TypeError, match="unexpected keyword"):
        serving.CFServer(R, no_such_option=1, device="cpu")
