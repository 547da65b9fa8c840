"""Port parity of ``repro_torch.launch.steps`` against
``repro.launch.steps``: the four analytic FLOP counts equal the
reference's exactly for every registered architecture and shape;
``build_cell``'s arguments for the recsys and cf families have the
shapes and dtypes of the reference's ``ShapeDtypeStruct``s (on a one-device
mesh), its row splits agree with the reference's partition specs for the
params and inputs; for the lm family (train, prefill and decode cells of
the five LM architectures) the arguments' shapes and dtypes and the FLOPs
equal the reference's, the tokens and the cache split by batch rows where
the reference's specs name a data axis, and the params are replicated;
the gnn family raises until its model lands.  A train cell of the tiny
gemma3-1b runs one step from zeros."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import repro.configs as jcfg
from repro.launch import steps as jsteps
from repro.launch.mesh import _mk
import repro_torch.configs as tcfg
from repro_torch.configs.base import ShapeSpec
from repro_torch.data import CTRStream
from repro_torch.distributed.sharding import Replicated, Rows
from repro_torch.launch import steps as tsteps
from repro_torch.tree import leaves, unflatten
from tests.conftest import reduced_spec

torch.set_num_threads(2)

FLOPS = {"lm": "lm_model_flops", "gnn": "gnn_model_flops",
         "recsys": "recsys_model_flops", "cf": "cf_model_flops"}
CASES = [(a, s.name) for a in jcfg.list_archs()
         for s in jcfg.get_arch(a).shapes]
CELL_CASES = [(a, s) for a, s in CASES
              if jcfg.get_arch(a).family in ("recsys", "cf")]
LM_CASES = [(a, s) for a, s in CASES if jcfg.get_arch(a).family == "lm"]


@pytest.fixture(scope="module")
def mesh():
    return _mk((1, 1), ("data", "model"))


def test_registries_agree():
    assert tcfg.list_archs() == jcfg.list_archs()


@pytest.mark.parametrize("arch,shape", CASES)
def test_model_flops_equal_the_reference(arch, shape):
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    fn = FLOPS[tspec.family]
    got = getattr(tsteps, fn)(tspec.config, tspec.shape(shape))
    want = getattr(jsteps, fn)(jspec.config, jspec.shape(shape))
    assert got == want and type(got) is type(want)


def _row_split(spec) -> bool:
    """A reference partition spec splits rows when its first entry names
    a mesh axis."""
    return len(spec) > 0 and spec[0] is not None


@pytest.mark.parametrize("arch,shape", CELL_CASES)
def test_build_cell_args_match_the_reference(arch, shape, mesh):
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    cell = tsteps.build_cell(tspec, tspec.shape(shape))
    jcell = jsteps.build_cell(jspec, jspec.shape(shape), mesh)
    assert cell.name == jcell.name
    assert cell.model_flops == jcell.model_flops
    got, want = leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert t.is_meta
        assert tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name
    # Row splits of the params and the inputs (the optimizer state's
    # ZeRO extension is a mesh rule the port does not have).
    tsh, jsh = cell.shardings, jcell.in_specs
    pairs = [(tsh[0], jsh[0]), (tsh[-1], jsh[-1])]
    if jspec.family == "cf" and len(tsh) == 3:
        pairs = list(zip(tsh, jsh))
    for t, j in pairs:
        tl = leaves(t)
        jl = jax.tree.leaves(j, is_leaf=lambda x: isinstance(x, P))
        assert len(tl) == len(jl)
        for rule, spec in zip(tl, jl):
            assert isinstance(rule, (Rows, Replicated))
            assert isinstance(rule, Rows) == _row_split(spec), (rule, spec)


def test_train_cell_runs_a_step_on_zeros():
    """The recsys train cell's function on zeros at a tiny batch: the
    reference launcher's start, one AdamW step; the loss is ln 2."""
    spec = reduced_spec("autoint")
    shape = ShapeSpec("train_batch", "train", {"batch": 16})
    cell = tsteps.build_cell(dataclasses.replace(spec, shapes=(shape,)),
                             shape)
    params, opt_state, _ = unflatten(cell.args, [
        torch.zeros(t.shape, dtype=t.dtype) for t in leaves(cell.args)])
    batch = {k: torch.as_tensor(v)
             for k, v in CTRStream(spec.config, 16)(0).items()}
    params, opt_state, loss = cell.fn(params, opt_state, batch)
    assert abs(float(loss) - np.log(2.0)) <= 1e-6
    assert int(opt_state.step) == 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "gat-cora"])
def test_lm_and_gnn_cells_raise(arch):
    """The gnn family raises until its model lands; the lm family builds
    every registered shape and raises only on a kind it does not have."""
    spec = tcfg.get_arch(arch)
    if spec.family == "gnn":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsteps.build_cell(spec, spec.shapes[0])
        return
    odd = ShapeSpec("odd", "retrieval", {"seq_len": 8, "global_batch": 2})
    with pytest.raises(ValueError, match="unknown LM"):
        tsteps.build_cell(spec, odd)


@pytest.mark.parametrize("arch,shape", LM_CASES)
def test_lm_cell_args_match_the_reference(arch, shape, mesh):
    """Meta arguments of the train, prefill and decode cells at the full
    registered configs: the reference's shapes and dtypes leaf by leaf,
    its name and FLOPs; tokens and cache split by batch rows exactly where
    the reference's specs put a data axis on the batch."""
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    cell = tsteps.build_cell(tspec, tspec.shape(shape))
    jcell = jsteps.build_cell(jspec, jspec.shape(shape), mesh)
    assert cell.name == jcell.name
    assert cell.model_flops == jcell.model_flops
    got, want = leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert t.is_meta and tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name
    assert all(isinstance(r, Replicated) for r in leaves(cell.shardings[0]))
    kind = tspec.shape(shape).kind
    if kind == "decode":
        tl, jl = leaves(cell.shardings[1:]), jax.tree.leaves(
            jcell.in_specs[1:], is_leaf=lambda x: isinstance(x, P))
        assert len(tl) == len(jl)
        for rule, spec in zip(tl, jl):
            # the batch of the cache (axis 1) and of the tokens (axis 0)
            # takes the data axes; ring_pos and pos name none
            if isinstance(rule, Rows):
                assert spec[rule.axis] is not None, (rule, spec)
            else:
                assert all(a is None for a in spec), (rule, spec)
    else:
        rule = cell.shardings[-1]["tokens"]
        spec = jcell.in_specs[-1]["tokens"]
        assert isinstance(rule, Rows) == _row_split(spec)


def test_lm_train_cell_runs_a_step_on_zeros():
    """The tiny gemma3-1b train cell on zeros: the launcher's start; every
    logit is 0, so the loss is ln V and no gradient moves a param."""
    spec = reduced_spec("gemma3-1b")
    tspec = tcfg.get_arch("gemma3-1b")
    shape = ShapeSpec("train_4k", "train", {"seq_len": 16,
                                            "global_batch": 2})
    cfg = _port_config(spec.config)
    cell = tsteps.build_cell(dataclasses.replace(tspec, config=cfg,
                                                 shapes=(shape,)), shape)
    params, opt_state, _ = unflatten(cell.args, [
        torch.zeros(t.shape, dtype=t.dtype) for t in leaves(cell.args)])
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)
    params, opt_state, loss = cell.fn(params, opt_state, {"tokens": tokens})
    assert abs(float(loss) - np.log(cfg.vocab_size)) <= 1e-5
    assert int(opt_state.step) == 1
    assert all(not p.any() for p in leaves(params))


def _port_config(jcfg_):
    from repro_torch.configs.base import LMConfig, MoEConfig
    kw = {f.name: getattr(jcfg_, f.name) for f in dataclasses.fields(jcfg_)}
    if jcfg_.moe is not None:
        kw["moe"] = MoEConfig(**dataclasses.asdict(jcfg_.moe))
    return LMConfig(**kw)


@pytest.mark.parametrize("world_size", [2, 4, 512])
def test_recsys_row_splits_divide(world_size):
    """Every table's rows split evenly over any world size dividing 512
    (the tables are padded to it)."""
    spec = tcfg.get_arch("xdeepfm")
    cell = tsteps.build_cell(spec, spec.shape("serve_p99"), world_size)
    for t, rule in zip(leaves(cell.args[0]), leaves(cell.shardings[0])):
        if isinstance(rule, Rows):
            sl = rule.slice(t.shape[0], world_size - 1)
            assert sl.stop == t.shape[0]
            assert sl.stop - sl.start == t.shape[0] // world_size
