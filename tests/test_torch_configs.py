"""Port parity: the port's own copy of the architecture registry
(``repro_torch.configs``) equals ``repro.configs``: the same arch ids,
every ``ArchSpec`` equal field by field, the same shape sets, the same
``pad_to_shard`` and field vocabularies."""
from __future__ import annotations

import dataclasses

import pytest
import torch

import repro.configs as jcfg
from repro.configs import _fields as jfields
from repro.configs import base as jbase
import repro_torch.configs as tcfg
from repro_torch.configs import _fields as tfields
from repro_torch.configs import base as tbase

torch.set_num_threads(2)

SHAPE_SETS = ("LM_SHAPES", "GNN_SHAPES", "RECSYS_SHAPES", "CF_SHAPES")


def test_list_archs_equal():
    assert tcfg.list_archs() == jcfg.list_archs()
    assert len(tcfg.list_archs()) == len(tbase._CONFIG_MODULES) == 11


def test_config_modules_in_reference_order():
    assert tbase._CONFIG_MODULES == jbase._CONFIG_MODULES


def test_all_equal():
    assert tcfg.__all__ == jcfg.__all__
    for name in tcfg.__all__:
        assert getattr(tcfg, name).__module__.startswith("repro_torch.")


@pytest.mark.parametrize("arch_id", jcfg.list_archs())
def test_arch_spec_equal_field_by_field(arch_id):
    got, want = tcfg.get_arch(arch_id), jcfg.get_arch(arch_id)
    assert type(got).__name__ == type(want).__name__ == "ArchSpec"
    assert type(got.config).__name__ == type(want.config).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [s.name for s in got.active_shapes()] == \
        [s.name for s in want.active_shapes()]
    cfg = got.config
    if hasattr(cfg, "param_count"):
        assert cfg.param_count() == want.config.param_count()
        assert cfg.active_param_count() == want.config.active_param_count()
    if hasattr(cfg, "total_vocab"):
        assert (cfg.n_sparse, cfg.total_vocab) == \
            (want.config.n_sparse, want.config.total_vocab)


@pytest.mark.parametrize("name", SHAPE_SETS)
def test_shape_sets_equal(name):
    got, want = getattr(tbase, name), getattr(jbase, name)
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]


@pytest.mark.parametrize("n", [0, 1, 511, 512, 513, 943, 129_490, 524_288])
@pytest.mark.parametrize("multiple", [512, 8, 1])
def test_pad_to_shard_equal(n, multiple):
    assert tbase.pad_to_shard(n, multiple) == jbase.pad_to_shard(n, multiple)


def test_field_vocabularies_equal():
    assert tfields.CRITEO39 == jfields.CRITEO39
    assert tfields.powerlaw_vocabs(12, largest=1000) == \
        jfields.powerlaw_vocabs(12, largest=1000)


def test_registry_refuses_duplicates_and_unknowns():
    spec = tcfg.get_arch("twinsearch-cf")
    with pytest.raises(ValueError, match="duplicate"):
        tcfg.register(spec)
    with pytest.raises(KeyError):
        tcfg.get_arch("no-such-arch")
    with pytest.raises(KeyError):
        spec.shape("no-such-shape")
