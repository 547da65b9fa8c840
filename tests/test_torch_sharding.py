"""Port parity of the mesh-shaped rules of
``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``.

Every spec tree the port returns equals the reference's leaf for leaf, as
tuples (the port's ``P`` normalises a one-name tuple to the name, as
``PartitionSpec`` does):

  * ``lm_shardings`` for every registered LM config x every LM shape, which
    covers ``lm_param_specs`` (train and prefill) and its weight-stationary
    ``decode=True`` rewrite (decode shapes), ``lm_cache_specs`` and
    ``lm_hooks``; where the reference attaches a ``MoEEPInfo``, so does
    the port, with equal fields (``mesh`` aside: the cells bind it);
  * ``lm_param_specs`` (both ``decode`` values) and ``lm_batch_specs`` per
    config;
  * ``gnn_shardings``, ``recsys_shardings`` (the params' structures from
    each package's own ``init_params``, on ``meta`` and under
    ``jax.eval_shape``) and ``cf_shardings`` for every registered shape;
  * ``zero_extend`` and ``_fsdp_axes`` over a sweep of specs and shapes.

Each runs on both production meshes, given as ``MeshAxes(dp, mp, sizes)``
(no process group is needed): one pod (16, 16) and two pods (2, 16, 16),
plus the two debug meshes for the sweeps.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import types

import pytest
import torch

import jax
from jax.sharding import PartitionSpec as JP

import repro.configs as jcfg
from repro.distributed import sharding as jshd
from repro.models import recsys as jrec
import repro_torch.configs as tcfg
from repro_torch.distributed import sharding as tshd
from repro_torch.models import recsys as trec
from repro_torch.tree import leaves

torch.set_num_threads(2)

MESHES = {"pod": ({"data": 16, "model": 16}, ("data",)),
          "two_pods": ({"pod": 2, "data": 16, "model": 16}, ("pod", "data")),
          "debug": ({"data": 2, "model": 4}, ("data",)),
          "debug_pods": ({"pod": 2, "data": 2, "model": 2},
                         ("pod", "data"))}
PRODUCTION = ("pod", "two_pods")


def _axes(name):
    sizes, dp = MESHES[name]
    return (tshd.MeshAxes(dp=dp, mp="model", sizes=dict(sizes)),
            jshd.MeshAxes(dp=dp, mp="model", sizes=dict(sizes)))


def _cases(family):
    return [(a, s.name) for a in jcfg.list_archs()
            if jcfg.get_arch(a).family == family
            for s in jcfg.get_arch(a).shapes]


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _jpaths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))
    return [jax.tree_util.keystr(p) for p, _ in flat]


def _tspecs(tree):
    """The port's spec leaves in ``jax.tree.leaves`` order (dict entries
    by sorted key); ``P`` is a leaf, though a tuple."""
    if tree is None:
        return []
    if isinstance(tree, tshd.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tspecs(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in _tspecs(sub)]
    return [tree]


def assert_specs_equal(got, want):
    """Leaf for leaf, as tuples, in the reference's tree order."""
    g, w = _tspecs(got), _jleaves(want)
    assert len(g) == len(w), (len(g), len(w), _jpaths(want))
    for path, a, b in zip(_jpaths(want), g, w):
        assert isinstance(a, tshd.P), (path, a)
        assert tuple(a) == tuple(b), (path, a, b)


def _hooks_equal(got, want):
    for f in ("acts", "logits", "moe_tokens", "moe_experts"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert tuple(a) == tuple(b), (f, a, b)
    assert (got.moe_ep is None) == (want.moe_ep is None)
    if want.moe_ep is not None:
        for f in want.moe_ep._fields:
            if f == "mesh":
                assert got.moe_ep.mesh is None
                continue
            a, b = getattr(got.moe_ep, f), getattr(want.moe_ep, f)
            if f.endswith("_spec"):
                a, b = tuple(a), tuple(b)
            assert a == b, (f, a, b)


@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch,shape", _cases("lm"))
def test_lm_shardings_match_the_reference(arch, shape, mesh):
    tax, jax_ = _axes(mesh)
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    ts, js = tspec.shape(shape), jspec.shape(shape)
    got = tshd.lm_shardings(tspec.config, tax, ts.kind,
                            ts.dim("global_batch"), ts.dim("seq_len"))
    want = jshd.lm_shardings(jspec.config, jax_, js.kind,
                             js.dim("global_batch"), js.dim("seq_len"))
    assert set(got) == set(want)
    _hooks_equal(got["hooks"], want["hooks"])
    for k in want:
        if k != "hooks":
            assert_specs_equal(got[k], want[k])
    moe = jspec.config.moe
    assert (got["hooks"].moe_ep is not None) == (
        moe is not None and moe.n_experts % 16 == 0
        and js.kind in ("train", "prefill"))


@functools.lru_cache(maxsize=None)
def _lm_param_specs(arch, mesh, decode):
    tax, jax_ = _axes(mesh)
    return (tshd.lm_param_specs(tcfg.get_arch(arch).config, tax, decode),
            jshd.lm_param_specs(jcfg.get_arch(arch).config, jax_, decode))


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch", [a for a in jcfg.list_archs()
                                  if jcfg.get_arch(a).family == "lm"])
def test_lm_param_specs_match_the_reference(arch, mesh, decode):
    got, want = _lm_param_specs(arch, mesh, decode)
    assert_specs_equal(got, want)
    tax, jax_ = _axes(mesh)
    assert_specs_equal(tshd.lm_batch_specs(tax), jshd.lm_batch_specs(jax_))
    # Every leaf of the layers' params is covered by a spec.
    structs = tcfg.get_arch(arch).config
    from repro_torch.models import transformer as tlm
    assert set(got["layers"]) == set(tlm.param_structs(structs)["layers"])


@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch,shape", _cases("gnn"))
def test_gnn_shardings_match_the_reference(arch, shape, mesh):
    tax, jax_ = _axes(mesh)
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    got = tshd.gnn_shardings(tspec.config, tax, tspec.shape(shape).kind)
    want = jshd.gnn_shardings(jspec.config, jax_, jspec.shape(shape).kind)
    assert_specs_equal(got, want)


@functools.lru_cache(maxsize=None)
def _recsys_structs(arch):
    jstructs = jax.eval_shape(lambda: jrec.init_params(
        jax.random.PRNGKey(0), jcfg.get_arch(arch).config))
    tstructs = trec.init_params(None, tcfg.get_arch(arch).config,
                                device="meta")
    return tstructs, jstructs


@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch,shape", _cases("recsys"))
def test_recsys_shardings_match_the_reference(arch, shape, mesh):
    tax, jax_ = _axes(mesh)
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    tstructs, jstructs = _recsys_structs(arch)
    assert [tuple(t.shape) for t in leaves(tstructs)] == [
        s.shape for s in jax.tree.leaves(jstructs)]
    got = tshd.recsys_shardings(tspec.config, tax, tspec.shape(shape).kind,
                                tstructs)
    want = jshd.recsys_shardings(jspec.config, jax_,
                                 jspec.shape(shape).kind, jstructs)
    assert_specs_equal(got, want)


@pytest.mark.parametrize("mesh", PRODUCTION)
@pytest.mark.parametrize("arch,shape", _cases("cf"))
def test_cf_shardings_match_the_reference(arch, shape, mesh):
    tax, jax_ = _axes(mesh)
    tspec, jspec = tcfg.get_arch(arch), jcfg.get_arch(arch)
    got = tshd.cf_shardings(tspec.config, tax, tspec.shape(shape).kind)
    want = jshd.cf_shardings(jspec.config, jax_, jspec.shape(shape).kind)
    assert_specs_equal(got, want)


def test_unknown_kinds_raise():
    tax, _ = _axes("pod")
    cfg = tcfg.get_arch("twinsearch-cf").config
    with pytest.raises(ValueError, match="unknown CF"):
        tshd.cf_shardings(cfg, tax, "train")
    with pytest.raises(ValueError, match="unknown GNN"):
        tshd.gnn_shardings(tcfg.get_arch("gat-cora").config, tax, "serve")
    with pytest.raises(ValueError, match="unknown LM"):
        tshd.lm_shardings(tcfg.get_arch("gemma3-1b").config, tax, "serve",
                          8, 64)


_SPECS = [(), (None,), ("model",), (None, "model"), ("model", None, None),
          (None, None, ("model", "data")), (("pod", "data"), None),
          ("data", None), (None, "pod"), (None, None, None, None)]
_SHAPES = [(1,), (16,), (7, 32), (64, 3), (32, 32, 32), (2, 64, 128, 512),
           (1, 64, 2048, 2048), (512, 1), (4096, 16)]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_zero_extend_matches_the_reference(mesh):
    tax, jax_ = _axes(mesh)
    n = 0
    for spec, shape in itertools.product(_SPECS, _SHAPES):
        if len(spec) > len(shape) or any(
                a not in tax.sizes for p in spec if p is not None
                for a in (p if isinstance(p, tuple) else (p,))):
            continue
        for start in range(len(shape) + 1):
            got = tshd.zero_extend(tshd.P(*spec), shape, tax, start=start)
            want = jshd.zero_extend(JP(*spec), shape, jax_, start=start)
            assert isinstance(got, tshd.P)
            assert tuple(got) == tuple(want), (spec, shape, start)
            n += 1
    for dim in (1, 2, 4, 16, 32, 48, 256, 1024, 1536, 2048, 5632):
        assert tshd._fsdp_axes(tax, dim) == jshd._fsdp_axes(jax_, dim), dim
    assert n > 50


def test_mesh_axes_properties_match_the_reference():
    for name in MESHES:
        tax, jax_ = _axes(name)
        assert (tax.all, tax.mp_size, tax.dp_size) == (
            jax_.all, jax_.mp_size, jax_.dp_size)
    assert dataclasses.fields(tshd.MeshAxes)[0].name == "dp"


def test_shard_shape_raises_or_pads_an_uneven_split():
    """An uneven split raises, as JAX's ``shard_shape``; with ``pad`` it
    takes the larger block (the dry run's per-rank shapes)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.empty(16, 16))
    sh = tshd.NamedSharding(mesh, tshd.P("data", "model"))
    assert sh.shard_shape((128, 32)) == sh.shard_shape((128, 32), pad=True) \
        == (8, 2)
    with pytest.raises(ValueError, match="does not split 16 ways"):
        sh.shard_shape((128, 1))
    assert sh.shard_shape((128, 1), pad=True) == (8, 1)
    assert sh.shard_shape((130, 17), pad=True) == (9, 2)
