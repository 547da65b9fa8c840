"""Port parity of ``repro_torch.launch.steps`` against
``repro.launch.steps``: the four analytic FLOP counts equal the
reference's exactly for every registered architecture and shape;
``build_cell`` on a (1, 1) mesh (a one-rank gloo group here, against the
reference's one-device mesh) gives, for every registered cell of the
four families, arguments with the shapes and dtypes of the reference's
``ShapeDtypeStruct``s, and in-specs (the optimizer state's ZeRO extension
included), out-specs and donated arguments equal to the reference's as
tuples, except that the gnn ``train_full`` cell holds labels and mask
whole as well as feats (its edge-parallel loss reads them on every rank).
The recsys tables' rows split evenly over meshes of 2, 4 and 512 ranks
(a fake process group).  A train cell of the tiny gemma3-1b runs one step
from zeros; one of the tiny molecule cell from seeded weights equals the
reference's step within float32 tolerance."""
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
from repro_torch.distributed.sharding import named
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_mesh, one_rank_mesh
from repro_torch.tree import leaves, unflatten
from tests.conftest import reduced_spec
from tests.test_torch_sharding import assert_specs_equal

torch.set_num_threads(2)

FLOPS = {"lm": "lm_model_flops", "gnn": "gnn_model_flops",
         "recsys": "recsys_model_flops", "cf": "cf_model_flops"}
CASES = [(a, s.name) for a in jcfg.list_archs()
         for s in jcfg.get_arch(a).shapes]
CELL_CASES = [(a, s) for a, s in CASES
              if jcfg.get_arch(a).family in ("recsys", "cf")]
LM_CASES = [(a, s) for a, s in CASES if jcfg.get_arch(a).family == "lm"]
GNN_CASES = [(a, s) for a, s in CASES if jcfg.get_arch(a).family == "gnn"]


@pytest.fixture(scope="module")
def mesh():
    return _mk((1, 1), ("data", "model"))


@pytest.fixture
def tmesh():
    """The port's (1, 1) mesh over a one-rank gloo group, closed after."""
    with one_rank_mesh("cpu") as m:
        yield m


def _assert_cell_specs(cell, jcell):
    assert len(cell.in_specs) == len(jcell.in_specs)
    for got, want in zip(cell.in_specs, jcell.in_specs):
        assert_specs_equal(got, want)
    if jcell.out_specs is None:
        assert cell.out_specs is None
    else:
        for got, want in zip(cell.out_specs, jcell.out_specs):
            assert_specs_equal(got, want)
    assert cell.donate == jcell.donate


def test_registries_agree():
    assert tcfg.list_archs() == jcfg.list_archs()


@pytest.mark.parametrize("arch,shape", CASES)
def test_model_flops_equal_the_reference(arch, shape):
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    fn = FLOPS[tspec.family]
    got = getattr(tsteps, fn)(tspec.config, tspec.shape(shape))
    want = getattr(jsteps, fn)(jspec.config, jspec.shape(shape))
    assert got == want and type(got) is type(want)


@pytest.mark.parametrize("arch,shape", CELL_CASES)
def test_build_cell_args_match_the_reference(arch, shape, mesh, tmesh):
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    cell = tsteps.build_cell(tspec, tspec.shape(shape), tmesh)
    jcell = jsteps.build_cell(jspec, jspec.shape(shape), mesh)
    assert cell.name == jcell.name
    assert cell.model_flops == jcell.model_flops
    got, want = leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert t.is_meta
        assert tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name
    # The params', the optimizer state's and the inputs' specs, and the
    # outputs'.
    _assert_cell_specs(cell, jcell)


def test_train_cell_runs_a_step_on_zeros(tmesh):
    """The recsys train cell's function on zeros at a tiny batch: the
    reference launcher's start, one AdamW step; the loss is ln 2."""
    spec = reduced_spec("autoint")
    shape = ShapeSpec("train_batch", "train", {"batch": 16})
    cell = tsteps.build_cell(dataclasses.replace(spec, shapes=(shape,)),
                             shape, tmesh)
    params, opt_state, _ = unflatten(cell.args, [
        torch.zeros(t.shape, dtype=t.dtype) for t in leaves(cell.args)])
    batch = {k: torch.as_tensor(v)
             for k, v in CTRStream(spec.config, 16)(0).items()}
    params, opt_state, loss = cell.fn(params, opt_state, batch)
    assert abs(float(loss) - np.log(2.0)) <= 1e-6
    assert int(opt_state.step) == 1


@pytest.mark.parametrize("arch", ["gemma3-1b", "gat-cora"])
def test_lm_and_gnn_cells_raise(arch, tmesh):
    """The lm and gnn families build every registered shape and raise only
    on a kind they do not have."""
    spec = tcfg.get_arch(arch)
    odd = ShapeSpec("odd", "retrieval", {"seq_len": 8, "global_batch": 2,
                                         "d_feat": 4})
    with pytest.raises(ValueError, match=f"unknown {spec.family.upper()}"):
        tsteps.build_cell(spec, odd, tmesh)


@pytest.mark.parametrize("arch,shape", GNN_CASES)
def test_gnn_cell_args_match_the_reference(arch, shape, mesh, tmesh):
    """Every GNN cell builds: its meta arguments have the reference's
    shapes and dtypes leaf by leaf, its name and FLOPs are the
    reference's, and its specs are the reference's, except that
    ``train_full`` holds labels and mask whole as well as feats."""
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    cell = tsteps.build_cell(tspec, tspec.shape(shape), tmesh)
    jcell = jsteps.build_cell(jspec, jspec.shape(shape), mesh)
    assert cell.name == jcell.name
    assert cell.model_flops == jcell.model_flops
    got, want = leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert t.is_meta and tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name
    full = tspec.shape(shape).kind == "train_full"
    if full:
        assert jcell.in_specs[-1]["feats"] == P(None, None)
        assert tuple(jcell.in_specs[-1]["labels"]) == ("data",)
        for k in ("labels", "mask"):
            assert tuple(cell.in_specs[-1][k]) == (None,)
        want_in = dict(jcell.in_specs[-1], labels=P(None), mask=P(None))
        jcell = dataclasses.replace(
            jcell, in_specs=(*jcell.in_specs[:-1], want_in))
    _assert_cell_specs(cell, jcell)


def test_gnn_molecule_cell_step_matches_the_reference():
    """One AdamW step of the molecule cell at a tiny batch on the CPU,
    from the reference's seeded weights: the loss within 1e-6 relative and
    every new param within 1e-6 of the reference's step."""
    from repro.data import molecule_batch
    from repro.models import gnn as jgnn
    from repro.training.optimizer import AdamW as JAdamW
    from repro_torch.bridge import params_from_numpy
    from repro_torch.training.optimizer import AdamW
    dims = {"n_nodes": 10, "n_edges": 14, "batch": 8, "d_feat": 16}
    tspec, jspec = tcfg.get_arch("gat-cora"), jcfg.get_arch("gat-cora")
    tshape = ShapeSpec("molecule", "train_batched", dims)
    jshape = jcfg.base.ShapeSpec("molecule", "train_batched", dims)
    with one_rank_mesh("cpu") as tm:
        cell = tsteps.build_cell(dataclasses.replace(tspec, shapes=(tshape,)),
                                 tshape, tm)
    jcell = jsteps.build_cell(dataclasses.replace(jspec, shapes=(jshape,)),
                              jshape, _mk((1, 1), ("data", "model")))
    jp = jgnn.init_params(jax.random.PRNGKey(3), jspec.config, 16, 2)
    batch = molecule_batch(0, batch=8, n_nodes=10, n_edges=14, d_feat=16)
    jparams, _, jloss = jcell.fn(jp, JAdamW(lr=3e-4, weight_decay=0.01)
                                 .init(jp), batch)
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    params, opt_state, loss = cell.fn(
        params, AdamW(lr=3e-4, weight_decay=0.01).init(params),
        {k: torch.as_tensor(v) for k, v in batch.items()})
    assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert int(opt_state.step) == 1
    for t, j in zip(leaves(params), jax.tree.leaves(jparams)):
        assert float(np.abs(t.numpy() - np.asarray(j)).max()) <= 1e-6


@pytest.mark.parametrize("arch,shape", LM_CASES)
def test_lm_cell_args_match_the_reference(arch, shape, mesh, tmesh):
    """Meta arguments of the train, prefill and decode cells at the full
    registered configs: the reference's shapes and dtypes leaf by leaf,
    its name and FLOPs, and its in-specs, out-specs and donated
    arguments."""
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    cell = tsteps.build_cell(tspec, tspec.shape(shape), tmesh)
    jcell = jsteps.build_cell(jspec, jspec.shape(shape), mesh)
    assert cell.name == jcell.name
    assert cell.model_flops == jcell.model_flops
    got, want = leaves(cell.args), jax.tree.leaves(jcell.args)
    assert len(got) == len(want)
    for t, s in zip(got, want):
        assert t.is_meta and tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == np.dtype(s.dtype).name
    _assert_cell_specs(cell, jcell)


def test_lm_train_cell_runs_a_step_on_zeros(tmesh):
    """The tiny gemma3-1b train cell on zeros: the launcher's start; every
    logit is 0, so the loss is ln V and no gradient moves a param."""
    spec = reduced_spec("gemma3-1b")
    tspec = tcfg.get_arch("gemma3-1b")
    shape = ShapeSpec("train_4k", "train", {"seq_len": 16,
                                            "global_batch": 2})
    cfg = _port_config(spec.config)
    cell = tsteps.build_cell(dataclasses.replace(tspec, config=cfg,
                                                 shapes=(shape,)), shape,
                             tmesh)
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
    (the tables are padded to it): a (world_size, 1) mesh over a fake
    process group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    spec = tcfg.get_arch("xdeepfm")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        m = make_mesh((world_size, 1), ("data", "model"), device_type="cpu")
        cell = tsteps.build_cell(spec, spec.shape("serve_p99"), m)
        shardings = leaves(named(m, cell.in_specs[0]))
    finally:
        dist.destroy_process_group()
    n_split = 0
    for t, sh in zip(leaves(cell.args[0]), shardings):
        if tuple(sh.spec[:1]) == (("data", "model"),):
            n_split += 1
            sl = sh.indices(tuple(t.shape), world_size - 1)[0]
            assert sl.stop == t.shape[0]
            assert sl.stop - sl.start == t.shape[0] // world_size
            assert sh.shard_shape(tuple(t.shape))[0] * world_size == \
                t.shape[0]
        else:
            assert all(p is None for p in sh.spec)
    assert n_split >= 2
