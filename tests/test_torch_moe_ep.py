"""Port parity of ``repro_torch.models.moe_ep`` (expert parallelism on
``torch.distributed``) and of ``distributed.sharding.named`` against the
JAX reference.

  * Eight spawned gloo ranks (a ``FileStore`` under ``tmp_path``) on the
    (2, 2, 2) debug mesh (``make_debug_mesh(multi_pod=True)``, ``mp_size``
    2), ``tests/test_distributed.py``'s MoE case: 4 experts, top-2,
    capacity factor 8.0, d 16, swiglu, activations ``P(("pod", "data"),
    "model", None)``.  Three layouts in one spawn: experts over the model
    axis (``P("model", None, None)``); FSDP with ``("pod", "data")`` on the
    weights' last axis (gathered in the forward, reduce-scattered in the
    backward); and activations replicated over the model axis
    (``P(("pod", "data"), None, None)``, the LM cells' spec when
    ``seq_shard`` is off), whose cotangents the ranks of a model row
    share.  Each rank passes its blocks (``named(mesh, spec).indices``)
    and differentiates sum(out·g) + aux for a fixed random g.  Held to the reference, run in a subprocess on 8 host
    devices: the output within 1e-5 of ``moe_ffn`` (nothing overflows
    capacity), and output, aux loss and the gradients of x, router, w_in and
    w_out within 1e-5 of ``moe_ffn_ep`` under ``jax.grad``, each rank's
    block against the reference's block for that device.  The reference's
    subprocess and the spawn take about 16 s together on an 8-core CPU
    host (each rank imports torch); they run at a lower CPU priority
    (``os.nice(10)``), so that nine processes at once do not slow the
    suite's other workers, and every process is joined within 240 s.
  * ``named(...).shard_shape`` and ``indices`` for every leaf of a reduced
    OLMoE train and decode cell (``tests/test_distributed.py``'s shrunken
    config) on the (2, 2, 2) debug mesh, built on a fake 8-rank process
    group, equal JAX's ``NamedSharding.shard_shape`` and
    ``devices_indices_map`` for every rank.
  * One gloo rank in this process (``HashStore``): a reduced OLMoE train
    and prefill cell (float32) through ``build_cell`` on a (1, 1) mesh take
    ``moe_ffn_ep`` (counted), and equal the reference's cell on one device:
    the loss within 1e-6 relative and each gradient leaf within 1e-4 of its
    largest value (the train cell; gradients read from its step), each
    updated param within 2·lr of the reference's (AdamW's first step moves
    a param by about lr·sign(g), so a gradient within float noise of 0 may
    move it either way), and the prefill's logits and cache within 2e-5 of
    their largest value (``tests/test_torch_transformer.py``'s float32
    bounds).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.configs.base import MoEConfig as JMoEConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.launch import steps as jsteps
from repro.launch.mesh import _mk
from repro.models import transformer as jlm
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_arch
from repro_torch.configs.base import MoEConfig, ShapeSpec
from repro_torch.distributed.sharding import named
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_debug_mesh, one_rank_mesh
from repro_torch.models import transformer as tlm
from repro_torch.training import train_loop
from repro_torch.tree import leaves

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LAYOUTS = ("model", "fsdp", "acts_rep")
GRADS = ("x", "rw", "wi", "wo")
# tests/test_distributed.py's shrunken OLMoE.
SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
             vocab_size=512)
SMALL_MOE = dict(n_experts=4, top_k=2, d_ff_expert=64)
INDEX_SHAPES = {"train": ("train", {"seq_len": 256, "global_batch": 8}),
                "decode": ("decode", {"seq_len": 256, "global_batch": 8})}


# ---------------------------------------------------------------------------
# The reference on 8 host devices (a subprocess: the device count must be
# set before jax starts)
# ---------------------------------------------------------------------------

_JAX_SCRIPT = r"""
import os, sys, json, dataclasses
os.nice(10)             # yield the CPU to the suite's other workers
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.launch.mesh import make_debug_mesh
from repro.configs.base import MoEConfig
from repro.models.moe import moe_ffn
from repro.models.moe_ep import moe_ffn_ep, MoEEPInfo
mesh = make_debug_mesh(multi_pod=True)
cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0)
key = jax.random.PRNGKey(0)
x = jax.random.normal(key, (4, 32, 16), jnp.float32)
rw = jax.random.normal(jax.random.PRNGKey(1), (16, 4)) * 0.1
wi = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 64)) * 0.1
wo = jax.random.normal(jax.random.PRNGKey(3), (4, 32, 16)) * 0.1
g = jax.random.normal(jax.random.PRNGKey(4), (4, 32, 16), jnp.float32)
out = {"x": x, "rw": rw, "wi": wi, "wo": wo, "g": g}
out["plain"], _ = moe_ffn(x, rw, wi, wo, None, cfg, "swiglu", group_size=32)
layouts = {"model": (P(("pod", "data"), "model", None),
                     P("model", None, None)),
           "fsdp": (P(("pod", "data"), "model", None),
                    P("model", None, ("pod", "data"))),
           "acts_rep": (P(("pod", "data"), None, None),
                        P("model", None, None))}
for layout, (acts, ws) in layouts.items():
    info = MoEEPInfo(dp=("pod", "data"), mp="model", mp_size=2,
                     win_spec=ws, wout_spec=ws, acts_spec=acts, mesh=mesh)
    f = lambda *a: moe_ffn_ep(*a, cfg, "swiglu", info)
    def loss(*a):
        y, aux = f(*a)
        return jnp.sum(y * g) + aux
    with mesh:
        y, aux = jax.jit(f)(x, rw, wi, wo)
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(x, rw, wi, wo)
    out[f"{layout}/out"], out[f"{layout}/aux"] = y, aux
    for name, gr in zip(("x", "rw", "wi", "wo"), grads):
        out[f"{layout}/grad_{name}"] = gr
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})

# Shard shapes and index maps of a reduced OLMoE train and decode cell.
from repro.configs import get_arch
from repro.configs.base import ShapeSpec, MoEConfig as MC
from repro.launch.steps import build_cell
spec = get_arch("olmoe-1b-7b")
small = dataclasses.replace(spec.config, **json.loads(sys.argv[3]),
                            moe=MC(**json.loads(sys.argv[4])))
spec = dataclasses.replace(spec, config=small)
maps = {}
for name, (kind, dims) in json.loads(sys.argv[5]).items():
    cell = build_cell(spec, ShapeSpec(name, kind, dims), mesh)
    specs = jax.tree.leaves(cell.in_specs, is_leaf=lambda s: isinstance(s, P))
    args = jax.tree.leaves(cell.args)
    rows = []
    for s, a in zip(specs, args):
        sh = NamedSharding(mesh, s)
        idx = sh.devices_indices_map(a.shape)
        rows.append({"shape": list(a.shape),
                     "shard_shape": list(sh.shard_shape(a.shape)),
                     "indices": [[[sl.start, sl.stop, sl.step]
                                  for sl in idx[d]]
                                 for d in sorted(idx, key=lambda d: d.id)]})
    maps[name] = rows
with open(sys.argv[2], "w") as fh:
    json.dump(maps, fh)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_ep_ref")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "ref.npz"),
         str(d / "maps.json"), json.dumps(SMALL), json.dumps(SMALL_MOE),
         json.dumps(INDEX_SHAPES)], env=env, capture_output=True, text=True,
        timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    with open(d / "maps.json") as fh:
        maps = json.load(fh)
    return dict(np.load(d / "ref.npz")), maps


# ---------------------------------------------------------------------------
# Eight spawned ranks
# ---------------------------------------------------------------------------

_RANK_SCRIPT = r"""
import os, sys
os.nice(10)             # yield the CPU to the suite's other workers
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.configs.base import MoEConfig
from repro_torch.distributed.sharding import P, named
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models.moe_ep import MoEEPInfo, moe_ffn_ep
src, store_path, rank, dst = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 8),
                        rank=rank, world_size=8)
mesh = make_debug_mesh(multi_pod=True, device_type="cpu")
data = np.load(src)
cfg = MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, capacity_factor=8.0)
layouts = {"model": (P(("pod", "data"), "model", None),
                     P("model", None, None)),
           "fsdp": (P(("pod", "data"), "model", None),
                    P("model", None, ("pod", "data"))),
           "acts_rep": (P(("pod", "data"), None, None),
                        P("model", None, None))}
out = {}
for layout, (acts, ws) in layouts.items():
    def block(name, spec):
        a = data[name]
        return torch.tensor(a[named(mesh, spec).indices(a.shape, rank)])
    x = block("x", acts).requires_grad_()
    g = block("g", acts)
    rw = torch.tensor(data["rw"]).requires_grad_()
    wi = block("wi", ws).requires_grad_()
    wo = block("wo", ws).requires_grad_()
    info = MoEEPInfo(dp=("pod", "data"), mp="model", mp_size=2,
                     win_spec=ws, wout_spec=ws, acts_spec=acts, mesh=mesh)
    y, aux = moe_ffn_ep(x, rw, wi, wo, cfg, "swiglu", info)
    (torch.sum(y * g) + aux).backward()
    out[f"{layout}/out"] = y.detach().numpy()
    out[f"{layout}/aux"] = aux.detach().numpy()
    for name, t in (("x", x), ("rw", rw), ("wi", wi), ("wo", wo)):
        out[f"{layout}/grad_{name}"] = t.grad.numpy()
dist.destroy_process_group()
np.savez(dst, **out)
"""


def _run_all(procs: list[subprocess.Popen], timeout_s: float) -> None:
    """Join every process within ``timeout_s``; kill them all on expiry
    (a hung rendezvous) and fail."""
    errs = []
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=timeout_s)
            errs.append(err)
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.communicate()
        pytest.fail(f"spawned processes did not finish in {timeout_s} s")
    for proc, err in zip(procs, errs):
        assert proc.returncode == 0, err[-3000:]


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    """The eight ranks' outputs and gradients, both layouts, one spawn."""
    ref, _ = reference
    d = tmp_path_factory.mktemp("moe_ep_ranks")
    src = d / "inputs.npz"
    np.savez(src, **{k: ref[k] for k in ("x", "rw", "wi", "wo", "g")})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(src), str(d / "store"),
         str(rank), str(d / f"rank{rank}.npz")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT)) for rank in range(8)]
    _run_all(procs, 240.0)
    return [dict(np.load(d / f"rank{rank}.npz")) for rank in range(8)]


def _debug_mesh_stand_in():
    """The (2, 2, 2) mesh's names and rank layout, for ``named`` on the
    host (``indices`` reads only these)."""
    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        mesh = torch.arange(8).view(2, 2, 2)
        device_type = "cpu"
    return Mesh()


def _spec(layout, name):
    from repro_torch.distributed.sharding import P
    acts = P(("pod", "data"), None if layout == "acts_rep" else "model",
             None)
    ws = P("model", None, ("pod", "data") if layout == "fsdp" else None)
    return {"x": acts, "out": acts, "rw": P(), "wi": ws, "wo": ws}[name]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_eight_ranks_match_the_reference(reference, ranks, layout):
    ref, _ = reference
    mesh = _debug_mesh_stand_in()
    for rank, got in enumerate(ranks):
        blk = named(mesh, _spec(layout, "out")).indices(ref["plain"].shape,
                                                        rank)
        out = got[f"{layout}/out"]
        assert out.shape == ref["plain"][blk].shape
        assert float(np.abs(out - ref["plain"][blk]).max()) < 1e-5
        assert float(np.abs(out - ref[f"{layout}/out"][blk]).max()) < 1e-5
        assert abs(float(got[f"{layout}/aux"]) -
                   float(ref[f"{layout}/aux"])) < 1e-5
        for name in GRADS:
            want = ref[f"{layout}/grad_{name}"]
            want = want[named(mesh, _spec(layout, name)).indices(want.shape,
                                                                 rank)]
            g = got[f"{layout}/grad_{name}"]
            assert g.shape == want.shape, (name, g.shape, want.shape)
            err = float(np.abs(g - want).max())
            assert err < 1e-5, (layout, rank, name, err)


# ---------------------------------------------------------------------------
# named() against JAX's index maps on the debug mesh
# ---------------------------------------------------------------------------

def _port_small_spec():
    spec = get_arch("olmoe-1b-7b")
    cfg = dataclasses.replace(spec.config, **SMALL,
                              moe=MoEConfig(**SMALL_MOE))
    return dataclasses.replace(spec, config=cfg)


@pytest.mark.parametrize("name", list(INDEX_SHAPES))
def test_named_matches_jax_index_maps(reference, name):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _, maps = reference
    kind, dims = INDEX_SHAPES[name]
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_debug_mesh(multi_pod=True, device_type="cpu")
        cell = tsteps.build_cell(_port_small_spec(),
                                 ShapeSpec(name, kind, dims), mesh)
        shardings = leaves(named(mesh, cell.in_specs))
        args = leaves(cell.args)
    finally:
        dist.destroy_process_group()
    rows = maps[name]
    assert len(shardings) == len(args) == len(rows)
    for sh, arg, row in zip(shardings, args, rows):
        assert list(arg.shape) == row["shape"]
        assert list(sh.shard_shape(tuple(arg.shape))) == row["shard_shape"]
        for rank in range(8):
            got = [[s.start, s.stop, s.step]
                   for s in sh.indices(tuple(arg.shape), rank)]
            assert got == row["indices"][rank], (row["shape"], sh.spec,
                                                 rank)


# ---------------------------------------------------------------------------
# One rank in this process: the OLMoE cells through moe_ep
# ---------------------------------------------------------------------------

def _jcfg32():
    spec = jget_arch("olmoe-1b-7b")
    return dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, **SMALL, moe=JMoEConfig(**SMALL_MOE), dtype="float32"))


def _tcfg32():
    spec = get_arch("olmoe-1b-7b")
    return dataclasses.replace(spec, config=dataclasses.replace(
        spec.config, **SMALL, moe=MoEConfig(**SMALL_MOE), dtype="float32"))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_one_rank_olmoe_cell_takes_moe_ep(kind, monkeypatch):
    jspec, tspec = _jcfg32(), _tcfg32()
    dims = {"seq_len": 32, "global_batch": 2}
    jparams = jax.jit(lambda k: jlm.init_params(k, jspec.config))(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        0, SMALL["vocab_size"], (2, 32)).astype(np.int32)
    jmesh = _mk((1, 1), ("data", "model"))
    jcell = jsteps.build_cell(jspec, JShapeSpec("c", kind, dims), jmesh)
    calls = []
    real_ep = tlm.moe_ffn_ep
    monkeypatch.setattr(tlm, "moe_ffn_ep",
                        lambda *a: calls.append(1) or real_ep(*a))
    seen = {}
    real_vg = train_loop.value_and_grad

    def recording(fn, params, batch):
        loss, grads = real_vg(fn, params, batch)
        seen["grads"] = grads
        return loss, grads
    monkeypatch.setattr(tsteps, "value_and_grad", recording)
    assert not dist.is_initialized()
    with one_rank_mesh("cpu") as mesh:
        cell = tsteps.build_cell(tspec, ShapeSpec("c", kind, dims), mesh)
        params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        batch = {"tokens": torch.as_tensor(tokens)}
        if kind == "train":
            from repro.training.optimizer import AdamW as JAdamW
            from repro_torch.training.optimizer import AdamW
            with jmesh:
                jnew, _, jloss = jcell.fn(
                    jparams, JAdamW(lr=3e-4, weight_decay=0.01).init(
                        jparams), {"tokens": jnp.asarray(tokens)})
            hooks = jsteps.shd.lm_shardings(
                jspec.config, jsteps.shd.mesh_axes(jmesh), "train", 2,
                32)["hooks"]
            hooks = hooks._replace(moe_ep=hooks.moe_ep._replace(mesh=jmesh))
            with jmesh:
                jgrads = jax.grad(lambda p: jlm.lm_loss(
                    p, jnp.asarray(tokens), jspec.config, hooks))(jparams)
            new, opt_state, loss = cell.fn(
                params, AdamW(lr=3e-4, weight_decay=0.01).init(params),
                batch)
            assert abs(float(loss) - float(jloss)) <= 1e-6 * abs(
                float(jloss))
            assert int(opt_state.step) == 1
            for g, w in zip(leaves(seen["grads"]), jax.tree.leaves(jgrads)):
                assert np.abs(np.asarray(w)).max() > 0
                assert _rel(g.detach(), w) <= 1e-4
            # AdamW's first step moves each param by about lr·sign(g): a
            # gradient within float noise of 0 may move either way.
            for t, w in zip(leaves(new), jax.tree.leaves(jnew)):
                assert float(np.abs(t.detach().numpy() - np.asarray(w))
                             .max()) <= 2 * 3e-4 + 1e-6
        else:
            with jmesh:
                jlogits, jcache = jcell.fn(jparams, {"tokens": jnp.asarray(
                    tokens)})
            with torch.no_grad():
                logits, cache = cell.fn(params, batch)
            assert _rel(logits, jlogits) <= 2e-5
            for k in jcache:
                if k == "ring_pos":
                    assert np.array_equal(cache[k].numpy(),
                                          np.asarray(jcache[k]))
                else:
                    assert _rel(cache[k], jcache[k]) <= 2e-5, k
    assert not dist.is_initialized()
    assert len(calls) == SMALL["n_layers"] * (2 if kind == "train" else 1)
