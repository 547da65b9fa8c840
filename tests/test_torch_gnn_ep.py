"""Port parity of ``repro_torch.models.gnn_ep`` (the edge-parallel GAT on
``torch.distributed``) against the JAX reference.

  * World size 1, in this process (gloo over a ``HashStore``): the loss and
    every gradient leaf against ``repro.models.gnn_ep.loss_full_ep`` on a
    one-device mesh.
  * World size 2, two spawned ranks (gloo over a ``FileStore``) on a
    (2, 1) mesh, each holding its half of the edge list
    (``named(mesh, gnn_shardings(...))``) and naming the mesh's axes in its
    ``GNNEPInfo``: the loss and every gradient leaf against
    ``repro.models.gnn.loss_full`` on the graph of
    ``tests/test_distributed.py`` (64 nodes, 192 edges plus self-loops),
    within that file's bounds: loss 1e-5, gradients 1e-6.  The two ranks'
    gradients are identical, so the optimizer keeps them in step.
  * The chunked message sum against one chunk, with chunks that do not
    divide the edge count: the layer's output and the loss's gradients.
  * Without a process group the entry points raise ``RuntimeError``.

Other tolerances (float32): against the one-device reference, the loss
within 1e-6 relative and each gradient leaf within 1e-5 of its largest
|reference value|; chunked against one chunk (only the order of float
sums differs), 1e-6 of the largest |value|.  Every spawned process is
joined with a timeout and killed on expiry.
"""
from __future__ import annotations

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
from jax.sharding import Mesh

from repro.configs.base import GNNConfig as JGNNConfig
from repro.models import gnn as jgnn
from repro.models import gnn_ep as jep
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import GNNConfig
from repro_torch.models import gnn as tgnn
from repro_torch.models import gnn_ep as tep
from repro_torch.training.train_loop import value_and_grad

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
KEYS = [(layer, k) for layer in ("l1", "l2") for k in ("W", "a_src", "a_dst")]


@pytest.fixture
def group1():
    """A one-rank gloo process group in this process, torn down after."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _case():
    """``tests/test_distributed.py``'s edge-parallel case, drawn the same
    way: params, feats and labels from JAX keys, as numpy."""
    gcfg = JGNNConfig(name="g", n_layers=2, d_hidden=8, n_heads=8,
                      n_classes=7)
    key = jax.random.PRNGKey(0)
    N, E = 64, 192
    p = jgnn.init_params(key, gcfg, d_feat=16)
    src = jnp.concatenate([jax.random.randint(key, (E,), 0, N),
                           jnp.arange(N)])
    dst = jnp.concatenate([jax.random.randint(jax.random.PRNGKey(9), (E,),
                                              0, N), jnp.arange(N)])
    batch = {"feats": jax.random.normal(key, (N, 16)), "edge_src": src,
             "edge_dst": dst,
             "labels": jax.random.randint(key, (N,), 0, 7),
             "mask": jnp.ones(N, bool)}
    return gcfg, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray,
                                                            batch)


def _port_cfg(gcfg) -> GNNConfig:
    return GNNConfig(name=gcfg.name, n_layers=gcfg.n_layers,
                     d_hidden=gcfg.d_hidden, n_heads=gcfg.n_heads,
                     n_classes=gcfg.n_classes)


def _port_loss_and_grads(cfg, p, batch):
    return value_and_grad(
        lambda q, b: tep.loss_full_ep(q, b, cfg, tep.GNNEPInfo()),
        params_from_numpy(p, "cpu"),
        {k: torch.as_tensor(v) for k, v in batch.items()})


def _assert_grads(grads, want, tol):
    for layer, k in KEYS:
        g = grads[layer][k]
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
        w = np.asarray(want[layer][k])
        assert float(np.abs(g - w).max()) <= tol, (layer, k)


# ---------------------------------------------------------------------------
# World size 1
# ---------------------------------------------------------------------------

def test_one_rank_matches_reference_on_one_device_mesh(group1):
    gcfg, p, batch = _case()
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    info = jep.GNNEPInfo(axes=("data",), mesh=mesh)
    with mesh:
        want, wgrads = jax.jit(jax.value_and_grad(
            lambda q, b: jep.loss_full_ep(q, b, gcfg, info)))(p, batch)
    got, grads = _port_loss_and_grads(_port_cfg(gcfg), p, batch)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    for layer, k in KEYS:
        w = np.asarray(wgrads[layer][k])
        err = float(np.abs(grads[layer][k].numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (layer, k, err)


@pytest.mark.parametrize("chunk", [37, 100, 255])
def test_chunked_message_sum_matches_one_chunk(group1, monkeypatch, chunk):
    """Chunks of 37, 100 and 255 edges over 256 (none divides it) against
    one chunk: the second layer's output (messages (E, 8, 7)) and every
    gradient leaf of the loss."""
    gcfg, p, batch = _case()
    cfg = _port_cfg(gcfg)
    tp = params_from_numpy(p, "cpu")
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    src, dst = tb["edge_src"].long(), tb["edge_dst"].long()
    row = cfg.n_heads * cfg.n_classes * 4

    def run():
        out = tep._gat_layer_local(
            torch.randn(64, 64, generator=torch.Generator().manual_seed(1)),
            src, dst, tp["l2"], cfg.n_heads, cfg.negative_slope, False,
            None)
        return out, _port_loss_and_grads(cfg, p, batch)

    monkeypatch.setattr(tep, "MSG_CHUNK_BYTES", 1 << 30)
    assert tep.edge_chunk(cfg.n_heads, cfg.n_classes, torch.float32) >= 256
    out1, (l1, g1) = run()
    monkeypatch.setattr(tep, "MSG_CHUNK_BYTES", chunk * row)
    assert tep.edge_chunk(cfg.n_heads, cfg.n_classes, torch.float32) == chunk
    outc, (lc, gc) = run()
    assert float((outc - out1).abs().max()) <= 1e-6 * float(
        out1.abs().max())
    assert abs(float(lc) - float(l1)) <= 1e-6 * abs(float(l1))
    for layer, k in KEYS:
        assert float((gc[layer][k] - g1[layer][k]).abs().max()) <= \
            1e-6 * float(g1[layer][k].abs().max()), (layer, k)


def test_without_a_process_group_raises():
    assert not dist.is_initialized()
    gcfg, p, batch = _case()
    with pytest.raises(RuntimeError, match="process group"):
        _port_loss_and_grads(_port_cfg(gcfg), p, batch)


# ---------------------------------------------------------------------------
# World size 2: spawned ranks against the unsharded reference
# ---------------------------------------------------------------------------

_RANK_SCRIPT = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import GNNConfig
from repro_torch.distributed import gnn_shardings, mesh_axes, named
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.gnn_ep import GNNEPInfo, loss_full_ep
from repro_torch.training.train_loop import value_and_grad
src, store_path, rank, dst = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
data = np.load(src)
cfg = GNNConfig(name="g", n_layers=2, d_hidden=8, n_heads=8, n_classes=7)
p = {l: {k: data[f"p/{l}/{k}"] for k in ("W", "a_src", "a_dst")}
     for l in ("l1", "l2")}
mesh = make_mesh((2, 1), ("data", "model"), device_type="cpu")
rules = named(mesh, gnn_shardings(cfg, mesh_axes(mesh),
                                  "train_full")["inputs"])
batch = {}
for k in ("feats", "edge_src", "edge_dst", "labels", "mask"):
    a = data[f"b/{k}"]
    if k.startswith("edge"):           # this rank's rows of the edge list
        a = a[rules[k].indices(a.shape, rank)]
    batch[k] = torch.as_tensor(a)
loss, grads = value_and_grad(
    lambda q, b: loss_full_ep(q, b, cfg, GNNEPInfo(axes=("data", "model"),
                                                   mesh=mesh)),
    params_from_numpy(p, "cpu"), batch)
out = {"loss": loss.numpy(), "n_edges": batch["edge_src"].shape[0]}
for l in ("l1", "l2"):
    for k in ("W", "a_src", "a_dst"):
        out[f"{l}/{k}"] = grads[l][k].numpy()
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


def test_two_ranks_match_unsharded_reference(tmp_path):
    gcfg, p, batch = _case()
    want, wgrads = jax.value_and_grad(jgnn.loss_full)(p, batch, gcfg)
    src = tmp_path / "inputs.npz"
    np.savez(src, **{f"p/{layer}/{k}": p[layer][k] for layer, k in KEYS},
             **{f"b/{k}": v for k, v in batch.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, str(src), str(store),
         str(rank), str(tmp_path / f"rank{rank}.npz")],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, cwd=str(ROOT)) for rank in range(2)]
    _run_all(procs, 240.0)
    outs = [np.load(tmp_path / f"rank{rank}.npz") for rank in range(2)]
    assert [int(o["n_edges"]) for o in outs] == [128, 128]
    for o in outs:
        assert abs(float(o["loss"]) - float(want)) < 1e-5
        _assert_grads({layer: {k: o[f"{layer}/{k}"] for k in
                               ("W", "a_src", "a_dst")}
                       for layer in ("l1", "l2")}, wgrads, 1e-6)
    for layer, k in KEYS:
        assert np.array_equal(outs[0][f"{layer}/{k}"],
                              outs[1][f"{layer}/{k}"])
