"""Port parity of ``repro_torch.models.gnn`` against ``repro.models.gnn``.

The same numpy inputs and weights (the reference's ``init_params``
carried across with ``bridge.params_from_numpy``) go through both
packages, float32 throughout:

  * ``gat_layer_segment``, concat on and off, on a graph with a node that
    has no in-edges and a node whose scores are all far below zero (its
    softmax underflows unless the segment max is that node's own);
  * ``gat_layer_fanout``, ``forward_segment``, ``forward_sampled``;
  * ``node_xent`` with a partial and an empty mask, ``graph_readout`` with
    an empty graph;
  * each of the three losses and every gradient leaf: ``loss_full`` at the
    registered gat-cora on ``cora_like(0)``, ``loss_sampled`` and
    ``loss_batched`` at the shapes of ``tests/test_arch_smoke.py``;
  * ``input_structs`` and the params' shapes against the reference's
    ``ShapeDtypeStruct``s for all four registered shapes.

Tolerances (float32; XLA and PyTorch sum in different orders): layer and
forward outputs within 1e-5 of the largest |reference value|; losses within
1e-6 relative; each gradient leaf within 1e-5 of its largest |reference
value|.  Integer and boolean structure exactly.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as jcfg
from repro.data import cora_like, molecule_batch
from repro.models import gnn as jgnn
import repro_torch.configs as tcfg
from repro_torch.bridge import params_from_numpy
from repro_torch.models import gnn as tgnn
from repro_torch.training.train_loop import value_and_grad

torch.set_num_threads(2)

OUT_TOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_TOL = 1e-5

CFG_J = jcfg.get_arch("gat-cora").config
CFG_T = tcfg.get_arch("gat-cora").config


def _close(got, want, tol=OUT_TOL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


def _params(d_feat, n_out=None, seed=0):
    jp = jgnn.init_params(jax.random.PRNGKey(seed), CFG_J, d_feat, n_out)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.as_tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _segment_case():
    """12 nodes; node 0's in-edges come from nodes 0 and 1, whose features
    make every score of node 0 lie below -104, where exp underflows to 0
    in float32 (W and a positive, the features negative); node 11 has no
    in-edges; the other nodes take 30 random edges and self-loops."""
    rng = np.random.default_rng(3)
    N, f_in, H, f_out = 12, 6, 4, 5
    x = rng.normal(size=(N, f_in)).astype(np.float32)
    x[:2] = -60.0 * np.abs(rng.normal(size=(2, f_in)))
    lp = {"W": 0.5 * np.abs(rng.normal(size=(f_in, H * f_out))),
          "a_src": np.abs(rng.normal(size=(H, f_out))),
          "a_dst": np.abs(rng.normal(size=(H, f_out)))}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    src = np.concatenate([rng.integers(0, N - 1, 30), [0, 1],
                          np.arange(1, N - 1)]).astype(np.int32)
    dst = np.concatenate([rng.integers(1, N - 1, 30), [0, 0],
                          np.arange(1, N - 1)]).astype(np.int32)
    return x, src, dst, lp, H


@pytest.mark.parametrize("concat", [True, False])
def test_gat_layer_segment_matches_reference(concat):
    x, src, dst, lp, H = _segment_case()
    want = np.asarray(jgnn.gat_layer_segment(
        jnp.asarray(x), jnp.asarray(src), jnp.asarray(dst),
        {k: jnp.asarray(v) for k, v in lp.items()}, H, concat=concat))
    got = tgnn.gat_layer_segment(_t(x), _t(src), _t(dst),
                                 {k: _t(v) for k, v in lp.items()}, H,
                                 concat=concat)
    # The case is what it claims: node 0's scores are all far below zero
    # yet its output is not 0 (its own max was subtracted), and node 11,
    # with no in-edges, is 0.
    Wh = (x @ lp["W"]).reshape(len(x), H, -1)
    e0 = np.einsum("nhf,hf->nh", Wh[[0, 1]], lp["a_src"]) + np.einsum(
        "hf,hf->h", Wh[0], lp["a_dst"])
    assert (0.2 * e0 < -104).all()
    assert np.abs(want[0]).min() > 0 and not want[-1].any()
    _close(got, want)


@pytest.mark.parametrize("concat", [True, False])
def test_gat_layer_fanout_matches_reference(concat):
    rng = np.random.default_rng(4)
    B, K, f_in, H, f_out = 6, 4, 7, 4, 3
    x_self = rng.normal(size=(B, f_in)).astype(np.float32)
    x_nbrs = rng.normal(size=(B, K, f_in)).astype(np.float32)
    lp = {"W": rng.normal(size=(f_in, H * f_out)),
          "a_src": rng.normal(size=(H, f_out)),
          "a_dst": rng.normal(size=(H, f_out))}
    lp = {k: v.astype(np.float32) for k, v in lp.items()}
    want = jgnn.gat_layer_fanout(jnp.asarray(x_self), jnp.asarray(x_nbrs),
                                 {k: jnp.asarray(v) for k, v in lp.items()},
                                 H, concat=concat)
    got = tgnn.gat_layer_fanout(_t(x_self), _t(x_nbrs),
                                {k: _t(v) for k, v in lp.items()}, H,
                                concat=concat)
    _close(got, want)


def test_forward_segment_matches_reference():
    x, src, dst, _, _ = _segment_case()
    jp, tp = _params(x.shape[1], seed=5)
    want = jgnn.forward_segment(jp, jnp.asarray(x), jnp.asarray(src),
                                jnp.asarray(dst), CFG_J)
    got = tgnn.forward_segment(tp, _t(x), _t(src), _t(dst), CFG_T)
    _close(got, want)


def _sampled_batch(N=60, d=16, B=8, f1=4, f2=3, n_out=5):
    """The sampled regime at ``tests/test_arch_smoke.py``'s shapes."""
    rng = np.random.default_rng(6)
    return {"feats": rng.normal(size=(N, d)).astype(np.float32),
            "roots": np.arange(B, dtype=np.int32),
            "nbr1": rng.integers(0, N, (B, f1)).astype(np.int32),
            "nbr2": rng.integers(0, N, (B * (1 + f1), f2)).astype(np.int32),
            "labels": rng.integers(0, n_out, B).astype(np.int32)}


def test_forward_sampled_matches_reference():
    b = _sampled_batch()
    jp, tp = _params(16, 5, seed=7)
    want = jgnn.forward_sampled(jp, *(jnp.asarray(b[k]) for k in
                                      ("feats", "roots", "nbr1", "nbr2")),
                                CFG_J)
    got = tgnn.forward_sampled(tp, *(_t(b[k]) for k in
                                     ("feats", "roots", "nbr1", "nbr2")),
                               CFG_T)
    _close(got, want)


# ---------------------------------------------------------------------------
# Losses and readouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask_kind", ["partial", "empty"])
def test_node_xent_matches_reference(mask_kind):
    rng = np.random.default_rng(8)
    logits = (3 * rng.normal(size=(10, 7))).astype(np.float32)
    labels = rng.integers(0, 7, 10).astype(np.int32)
    mask = (rng.random(10) < 0.5) if mask_kind == "partial" else \
        np.zeros(10, bool)
    want = float(jgnn.node_xent(jnp.asarray(logits), jnp.asarray(labels),
                                jnp.asarray(mask)))
    got = float(tgnn.node_xent(_t(logits), _t(labels), _t(mask)))
    assert abs(got - want) <= LOSS_RTOL * max(abs(want), 1e-30)


def test_graph_readout_matches_reference():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(20, 3)).astype(np.float32)
    gids = rng.integers(0, 4, 20).astype(np.int32)     # graph 4 is empty
    want = jgnn.graph_readout(jnp.asarray(logits), jnp.asarray(gids), 5)
    got = tgnn.graph_readout(_t(logits), _t(gids), 5)
    _close(got, want)
    assert not np.asarray(want)[4].any()


def _loss_case(kind):
    if kind == "train_full":
        data = cora_like(0)
        return data, _params(data["feats"].shape[1], seed=10)
    if kind == "train_sampled":
        return _sampled_batch(), _params(16, 5, seed=11)
    mol = molecule_batch(0, batch=8, n_nodes=10, n_edges=14, d_feat=16)
    return mol, _params(16, 2, seed=12)


@pytest.mark.parametrize("kind", ["train_full", "train_sampled",
                                  "train_batched"])
def test_loss_and_every_gradient_leaf_match_reference(kind):
    batch, (jp, tp) = _loss_case(kind)
    jloss = jgnn.LOSS_BY_KIND[kind]
    want, wgrads = jax.value_and_grad(
        lambda p: jloss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                        CFG_J))(jp)
    got, grads = value_and_grad(
        lambda p, b: tgnn.LOSS_BY_KIND[kind](p, b, CFG_T), tp,
        {k: _t(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    for layer in ("l1", "l2"):
        for k in ("W", "a_src", "a_dst"):
            _close(grads[layer][k], wgrads[layer][k], GRAD_TOL)


# ---------------------------------------------------------------------------
# Step inputs and params
# ---------------------------------------------------------------------------

N_OUT = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
         "molecule": 2}


@pytest.mark.parametrize("shape", [s.name for s in
                                   jcfg.get_arch("gat-cora").shapes])
def test_input_structs_and_params_match_reference(shape):
    jshape = jcfg.get_arch("gat-cora").shape(shape)
    tshape = tcfg.get_arch("gat-cora").shape(shape)
    want = jgnn.input_structs(CFG_J, jshape)
    got = tgnn.input_structs(CFG_T, tshape)
    assert list(got) == list(want)
    for k, s in want.items():
        assert got[k].is_meta and tuple(got[k].shape) == s.shape
        assert str(got[k].dtype).removeprefix("torch.") == \
            np.dtype(s.dtype).name
    d = jshape.dim("d_feat")
    jp = jax.eval_shape(lambda: jgnn.init_params(
        jax.random.PRNGKey(0), CFG_J, d, N_OUT[shape]))
    tp = tgnn.init_params(None, CFG_T, d, N_OUT[shape], device="meta")
    for layer in ("l1", "l2"):
        for k in ("W", "a_src", "a_dst"):
            assert tuple(tp[layer][k].shape) == jp[layer][k].shape
            assert tp[layer][k].dtype == torch.float32


def test_init_params_draws_from_the_generator():
    """Seeded: the same generator seed gives the same weights, another
    seed others; the scales are the reference's (fan-in for W, F**-0.5 for
    the attention vectors)."""
    a = tgnn.init_params(torch.Generator().manual_seed(0), CFG_T, 1433)
    b = tgnn.init_params(torch.Generator().manual_seed(0), CFG_T, 1433)
    c = tgnn.init_params(torch.Generator().manual_seed(1), CFG_T, 1433)
    assert torch.equal(a["l1"]["W"], b["l1"]["W"])
    assert not torch.equal(a["l1"]["W"], c["l1"]["W"])
    assert abs(float(a["l1"]["W"].std()) * 1433 ** 0.5 - 1) < 0.05
    assert abs(float(a["l2"]["W"].std()) * 64 ** 0.5 - 1) < 0.05
