"""Port parity of ``repro_torch.launch.steps`` against
``repro.launch.steps``: the four analytic FLOP counts equal the
reference's exactly for every registered architecture and shape;
``build_cell``'s arguments for the recsys and cf families have the
shapes and dtypes of the reference's ``ShapeDtypeStruct``s (on a one-device
mesh), its row splits agree with the reference's partition specs for the
params and inputs, and the lm and gnn families raise until their models
land."""
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
    spec = tcfg.get_arch(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tsteps.build_cell(spec, spec.shapes[0])


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
