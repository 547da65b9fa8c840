"""Port parity of ``repro_torch.models.embedding`` against
``repro.models.embedding``, on the same numpy inputs (made from a seed):
``field_offsets`` and ``lookup`` exactly; ``embedding_bag`` (sum and mean,
with and without offsets) and ``embedding_bag_ragged`` within 1e-6; the
table gradient of ``embedding_bag`` (the port's ``autograd.Function``,
whose forward runs ``kernels.embedding_bag.ops`` and whose backward
scatter-adds mask·grad) against ``jax.grad`` within 1e-6.  On the CPU
the bag's forward is the kernel's plain version."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import embedding as jemb
from repro_torch.configs.base import pad_to_shard
from repro_torch.models import embedding as temb

torch.set_num_threads(2)

TOL = 1e-6


def _table(seed: int, V: int, dim: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((V, dim)).astype(
        np.float32)


@pytest.mark.parametrize("vocab", [(5, 17, 3), (1000,), (8, 8, 8, 500)])
def test_field_offsets_and_init_table(vocab):
    assert np.array_equal(temb.field_offsets(vocab),
                          jemb.field_offsets(vocab))
    assert temb.field_offsets(vocab).dtype == np.int32
    t = temb.init_table(torch.Generator().manual_seed(0), vocab, 6)
    j = jemb.init_table(jax.random.PRNGKey(0), vocab, 6)
    assert tuple(t.shape) == j.shape == (pad_to_shard(sum(vocab)), 6)
    assert t.dtype == torch.float32
    m = temb.init_table(None, vocab, 6, device="meta")
    assert m.is_meta and tuple(m.shape) == j.shape


@pytest.mark.parametrize("lead", [(), (7,), (3, 4)])
def test_lookup_exact(lead):
    vocab = (11, 40, 3, 25)
    rng = np.random.default_rng(len(lead))
    table = _table(1, sum(vocab), 5)
    idx = np.stack([rng.integers(0, v, lead) for v in vocab],
                   axis=-1).astype(np.int32)
    offs = jemb.field_offsets(vocab)
    got = temb.lookup(torch.tensor(table), torch.tensor(idx), offs)
    want = np.asarray(jemb.lookup(jnp.asarray(table), jnp.asarray(idx),
                                  offs))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)


def test_offsets_reach_a_device_once():
    """The field offsets are copied to a device once per (values, dtype,
    device), not in every call: a forward on the card would otherwise wait
    on a host-to-device copy per lookup."""
    offs = temb.field_offsets((11, 40, 3))
    a = temb._offsets_on(offs, torch.long, torch.device("cpu"))
    assert temb._offsets_on(offs.copy(), torch.long, "cpu") is a
    assert temb._offsets_on(offs, torch.int32, "cpu").dtype == torch.int32
    other = temb._offsets_on(temb.field_offsets((11, 41, 3)), torch.long,
                             "cpu")
    assert other is not a and other.tolist() == [0, 11, 52]
    assert a.tolist() == [0, 11, 51]


def _bag_inputs(seed, lead, F, H, V, mask_kind="bool"):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, V // F, lead + (F, H)).astype(np.int32)
    if mask_kind == "bool":
        mask = rng.random(lead + (F, H)) < 0.6
        mask[..., 0, :] = False           # one all-empty bag per field 0
    else:
        mask = rng.random(lead + (F, H)).astype(np.float32)
    return idx, mask


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("offsets", [False, True])
@pytest.mark.parametrize("lead,F,H", [((6,), 1, 8), ((4,), 3, 5),
                                      ((2, 3), 2, 1)])
def test_embedding_bag_matches_reference(combiner, offsets, lead, F, H):
    V, dim = 300, 7
    table = _table(2, V, dim)
    idx, mask = _bag_inputs(3, lead, F, H, V)
    offs = (np.arange(F, dtype=np.int32) * (V // F)) if offsets else None
    got = temb.embedding_bag(torch.tensor(table), torch.tensor(idx),
                             torch.tensor(mask), offs, combiner)
    want = np.asarray(jemb.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(idx), jnp.asarray(mask),
                                         offs, combiner))
    assert got.shape == want.shape == lead + (F, dim)
    assert np.abs(got.numpy() - want).max() <= TOL


def test_embedding_bag_weighs_a_float_mask():
    """A float mask weighs each slot, as the reference's ``astype``."""
    table = _table(4, 200, 4)
    idx, mask = _bag_inputs(5, (9,), 2, 6, 200, mask_kind="float")
    got = temb.embedding_bag(torch.tensor(table), torch.tensor(idx),
                             torch.tensor(mask))
    want = np.asarray(jemb.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(idx),
                                         jnp.asarray(mask)))
    assert np.abs(got.numpy() - want).max() <= TOL


def test_embedding_bag_unknown_combiner_raises():
    t = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="combiner"):
        temb.embedding_bag(t, torch.zeros(1, 1, 2, dtype=torch.int32),
                           torch.ones(1, 1, 2, dtype=torch.bool),
                           combiner="max")


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("lead,F,H", [((16,), 1, 8), ((5,), 3, 4)])
def test_embedding_bag_table_gradient_matches_jax_grad(combiner, lead, F,
                                                       H):
    """d/d table of Σ (bag · c) for a fixed random c: the port's backward
    (dense zeros + ``index_add_`` of mask·grad) against ``jax.grad``.
    Repeated ids in a bag and across bags add up."""
    V, dim = 60, 5
    table = _table(6, V, dim)
    idx, mask = _bag_inputs(7, lead, F, H, V)
    c = np.random.default_rng(8).standard_normal(lead + (F, dim)).astype(
        np.float32)

    def jloss(t):
        return jnp.sum(jemb.embedding_bag(t, jnp.asarray(idx),
                                          jnp.asarray(mask),
                                          combiner=combiner) * c)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    out = temb.embedding_bag(t, torch.tensor(idx), torch.tensor(mask),
                             combiner=combiner)
    (got,) = torch.autograd.grad(torch.sum(out * torch.tensor(c)), t)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL
    untouched = np.setdiff1d(np.arange(V), idx[mask])
    assert not got.numpy()[untouched].any()


def test_lookup_gradient_matches_jax_grad():
    vocab = (20, 30)
    table = _table(9, 50, 3)
    idx = np.random.default_rng(10).integers(0, 20, (12, 2)).astype(
        np.int32)
    offs = jemb.field_offsets(vocab)
    c = np.random.default_rng(11).standard_normal((12, 2, 3)).astype(
        np.float32)
    want = np.asarray(jax.grad(lambda t: jnp.sum(jemb.lookup(
        t, jnp.asarray(idx), offs) * c))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    (got,) = torch.autograd.grad(torch.sum(temb.lookup(
        t, torch.tensor(idx), offs) * torch.tensor(c)), t)
    assert np.abs(got.numpy() - want).max() <= TOL


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_bags,T", [(5, 17), (1, 4), (9, 40)])
def test_embedding_bag_ragged_matches_reference(weighted, n_bags, T):
    rng = np.random.default_rng(n_bags * T)
    table = _table(12, 80, 6)
    flat = rng.integers(0, 80, T).astype(np.int32)
    seg = np.sort(rng.integers(0, n_bags, T)).astype(np.int32)
    w = rng.random(T).astype(np.float32) if weighted else None
    got = temb.embedding_bag_ragged(
        torch.tensor(table), torch.tensor(flat), torch.tensor(seg), n_bags,
        None if w is None else torch.tensor(w))
    want = np.asarray(jemb.embedding_bag_ragged(
        jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), n_bags,
        None if w is None else jnp.asarray(w)))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= TOL
