"""Port parity of ``repro_torch.models.recsys`` against
``repro.models.recsys`` for all four variants (xDeepFM, AutoInt, BST,
two-tower), at the reduced configs of ``tests/conftest.py`` with the JAX
weights carried across (``bridge.params_from_numpy``) and the batches of
the reference's streams: forward and loss within 1e-5, every gradient leaf
within 1e-4; ``retrieve`` scores within 1e-5 and ids exact except at
near-ties (``bridge.ranked_match``); the parameter trees of the registered
full-width configs (on the ``meta`` device) and ``input_structs`` for
every ``RECSYS_SHAPES`` entry with the reference's shapes and dtypes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as jget_arch
from repro.data import CTRStream as JCTRStream
from repro.data import TwoTowerStream as JTwoTowerStream
from repro.models import recsys as jrec
from repro_torch.bridge import params_from_numpy, ranked_match
from repro_torch.configs import get_arch
from repro_torch.configs.base import RECSYS_SHAPES, ShapeSpec
from repro_torch.models import recsys as trec
from repro_torch.training.train_loop import value_and_grad
from repro_torch.tree import leaves
from tests.conftest import reduced_spec

torch.set_num_threads(2)

ARCHS = ["xdeepfm", "autoint", "bst", "two-tower-retrieval"]
DTYPES = {jnp.dtype("int32"): torch.int32, jnp.dtype("float32"):
          torch.float32, jnp.dtype("bool"): torch.bool}


def _setup(arch: str, seed: int = 0, batch: int = 16):
    cfg = reduced_spec(arch).config
    jp = jrec.init_params(jax.random.PRNGKey(seed), cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    stream = JTwoTowerStream if cfg.variant == "two_tower" else JCTRStream
    b = stream(cfg, batch, seed=seed)(seed)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    return cfg, jp, tp, jb, tb


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match(arch, seed):
    cfg, jp, tp, jb, tb = _setup(arch, seed, batch=24)
    got = trec.forward(tp, tb, cfg)
    want = np.asarray(jrec.forward(jp, jb, cfg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.detach().numpy() - want).max() <= 1e-5
    gl = float(trec.loss(tp, tb, cfg).detach())
    assert abs(gl - float(jrec.loss(jp, jb, cfg))) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_leaf_matches(arch):
    cfg, jp, tp, jb, tb = _setup(arch, 2, batch=32)
    jl, jg = jax.value_and_grad(lambda p: jrec.loss(p, jb, cfg))(jp)
    tl_, tg = value_and_grad(lambda p, b: trec.loss(p, b, cfg), tp, tb)
    assert abs(float(tl_) - float(jl)) <= 1e-5
    jleaves, tleaves = jax.tree.leaves(jg), leaves(tg)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.shape == a.shape
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-4


@pytest.mark.parametrize("zeros", [0, 50, 200])
def test_bce_with_logits_and_its_gradient_match(zeros):
    """Value and gradient, with ``zeros`` logits of exactly 0, where the
    reference's gradient is -y (ROADMAP, reference quirks)."""
    rng = np.random.default_rng(3)
    z = (rng.standard_normal(200) * 30).astype(np.float32)
    z[:zeros] = 0.0
    y = (rng.random(200) < 0.5).astype(np.float32)
    tz = torch.tensor(z, requires_grad=True)
    got = trec.bce_with_logits(tz, torch.tensor(y))
    want, jg = jax.value_and_grad(jrec.bce_with_logits)(jnp.asarray(z),
                                                         jnp.asarray(y))
    assert abs(float(got.detach()) - float(want)) <= 1e-5
    (tg,) = torch.autograd.grad(got, tz)
    assert np.abs(tg.numpy() - np.asarray(jg)).max() <= 1e-7


def _retrieval_batch(cfg, C: int, seed: int):
    rng = np.random.default_rng(seed)
    fv = cfg.field_vocab_sizes
    b = {"user_id": rng.integers(0, cfg.user_vocab, 1).astype(np.int32),
         "user_fields": np.stack([rng.integers(0, v, 1) for v in fv[:4]],
                                 axis=1).astype(np.int32),
         "cand_ids": rng.choice(cfg.item_vocab, C, replace=False).astype(
             np.int32),
         "cand_fields": np.stack([rng.integers(0, v, C) for v in fv[4:6]],
                                 axis=1).astype(np.int32)}
    return b


@pytest.mark.parametrize("C,top_k", [(256, 10), (900, 100), (64, 64)])
def test_retrieve_matches(C, top_k):
    cfg, jp, tp, _, _ = _setup("two-tower-retrieval", 4)
    b = _retrieval_batch(cfg, C, C)
    vals, ids = trec.retrieve(tp, {k: torch.as_tensor(v)
                                   for k, v in b.items()}, cfg, top_k)
    jv, ji = jrec.retrieve(jp, {k: jnp.asarray(v) for k, v in b.items()},
                           cfg, top_k)
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (1, top_k)
    assert ranked_match(np.asarray(jv), np.asarray(ji), vals.numpy(),
                        ids.numpy(), 1e-5) is None


def test_retrieve_puts_the_lower_index_first_on_ties():
    """Duplicated candidates score equal; ``lax.top_k`` and the port both
    rank the lower position first."""
    cfg, jp, tp, _, _ = _setup("two-tower-retrieval", 5)
    b = _retrieval_batch(cfg, 40, 6)
    for k in ("cand_ids", "cand_fields"):
        b[k] = np.concatenate([b[k], b[k][::-1]])
    vals, ids = trec.retrieve(tp, {k: torch.as_tensor(v)
                                   for k, v in b.items()}, cfg, 30)
    jv, ji = jrec.retrieve(jp, {k: jnp.asarray(v) for k, v in b.items()},
                           cfg, 30)
    assert np.array_equal(ids.numpy(), np.asarray(ji))
    pairs = ids.numpy()[0].reshape(-1, 2)
    assert (pairs[:, 0] < pairs[:, 1]).all()


@pytest.mark.parametrize("arch", ["two-tower-retrieval"])
def test_user_and_item_embeddings_match(arch):
    cfg, jp, tp, jb, tb = _setup(arch, 7)
    for fn, a, b in (("user_embed", "user_id", "user_fields"),
                     ("item_embed", "item_id", "item_fields")):
        got = getattr(trec, fn)(tp, tb[a], tb[b], cfg)
        want = np.asarray(getattr(jrec, fn)(jp, jb[a], jb[b], cfg))
        assert np.abs(got.detach().numpy() - want).max() <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree_of_the_registered_config(arch):
    """Full width on the ``meta`` device: the reference's keys, shapes and
    dtypes, leaf for leaf."""
    cfg = get_arch(arch).config
    got = trec.init_params(None, cfg, device="meta")
    want = jax.eval_shape(lambda: jrec.init_params(jax.random.PRNGKey(0),
                                                   jget_arch(arch).config))
    jl = jax.tree_util.tree_leaves_with_path(want)
    tl_ = leaves(got)
    assert len(jl) == len(tl_)
    for (path, a), b in zip(jl, tl_):
        assert b.is_meta
        assert tuple(b.shape) == a.shape, path
        assert DTYPES[a.dtype] == b.dtype, path


@pytest.mark.parametrize("shape", RECSYS_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_structs_match(arch, shape):
    cfg = get_arch(arch).config
    got = trec.input_structs(cfg, shape)
    jshape = jget_arch(arch).shape(shape.name)
    want = jrec.input_structs(jget_arch(arch).config, jshape)
    assert list(got) == list(want)
    for k, s in want.items():
        assert got[k].is_meta
        assert tuple(got[k].shape) == s.shape, k
        assert got[k].dtype == DTYPES[s.dtype], k


def test_constants_match():
    for name in ("MULTI_HOT", "_N_USER_FIELDS", "_N_ITEM_FIELDS", "_ID_DIM",
                 "_FIELD_DIM"):
        assert getattr(trec, name) == getattr(jrec, name)


def test_retrieval_kind_ctr_input_structs_use_candidates():
    cfg = get_arch("xdeepfm").config
    s = ShapeSpec("r", "retrieval", {"batch": 1, "n_candidates": 77})
    assert tuple(trec.input_structs(cfg, s)["sparse_idx"].shape) == (77, 39)


def test_params_cross_both_ways_with_their_structure():
    """``bridge.params_from_numpy``/``params_to_numpy`` carry nested dicts,
    lists and NamedTuples (the reference's ``AdamWState``) leaf for leaf;
    bfloat16 stays bfloat16; the card is the default device."""
    from repro.training import AdamW as JAdamW
    from repro_torch.bridge import params_to_numpy
    from repro_torch.training import AdamWState
    cfg = reduced_spec("bst").config
    jp = jrec.init_params(jax.random.PRNGKey(3), cfg)
    js = JAdamW().init(jp)
    nested = jax.tree.map(np.asarray, (jp, js))
    tp, ts = params_from_numpy(nested, "cpu")
    ts = AdamWState(*ts)
    assert type(tp["blocks"]) is list and int(ts.step) == 0
    back = params_to_numpy((tp, ts))
    for a, b in zip(jax.tree.leaves(nested), leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = params_from_numpy({"w": jnp.ones((3, 2), jnp.bfloat16)}, "cpu")
    assert bf["w"].dtype == torch.bfloat16
    assert params_to_numpy(bf)["w"].dtype == np.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            params_from_numpy({"w": np.zeros(2)})
