"""Port parity of the public surface: ``repro_torch.serving``,
``repro_torch.data``, ``repro_torch.distributed`` and
``repro_torch.configs`` against the reference's snapshot in
``tests/test_api_surface.py``.

The port's ``serving.__all__`` is the reference's less ``LMServer`` (not
ported yet); the config, result and stats dataclasses have the reference's
field sets (``ServerStats`` may add timing fields); ``OnboardResult``
keeps the legacy ``(uid, info)`` protocol with the same answers as the
reference's.  ``data.__all__`` is the reference's less the two recsys
streams, and its rating generators give the reference's arrays for the
same seed; ``distributed.__all__`` is the reference's less its mesh-only
names; ``configs.__all__`` is the reference's.  A CPU server and the
reference's server onboard the same ratings through the legacy unpacking:
user ids, rungs, statuses and twin flags exact (a latency is a wall-clock
reading, so only its key mapping is held).
"""
from __future__ import annotations

import dataclasses
import itertools

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

NOT_PORTED = {"LMServer"}
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


# Wait for the recsys model (ROADMAP Queue 1, item 4).
DATA_NOT_PORTED = {"CTRStream", "TwoTowerStream"}
# Mesh-only names of ``repro.distributed``: they wait for the LM, GNN and
# recsys models (ROADMAP Queue 1, item 4).
DISTRIBUTED_NOT_PORTED = {"MeshAxes", "named", "zero_extend", "mesh_axes",
                          "lm_shardings", "gnn_shardings",
                          "recsys_shardings"}


def test_data_all_is_the_reference_less_recsys_streams():
    from repro_torch import data
    assert set(data.__all__) == set(jdata.__all__) - DATA_NOT_PORTED
    assert len(data.__all__) == len(set(data.__all__))
    for name in data.__all__:
        assert getattr(data, name).__module__.startswith("repro_torch.")


def test_distributed_all_is_the_reference_less_mesh_names():
    import repro.distributed as jdist
    import repro_torch.distributed as tdist
    assert set(tdist.__all__) == set(jdist.__all__) - DISTRIBUTED_NOT_PORTED
    assert DISTRIBUTED_NOT_PORTED <= set(jdist.__all__)
    for name in tdist.__all__:
        assert getattr(tdist, name).__module__.startswith("repro_torch.")


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
