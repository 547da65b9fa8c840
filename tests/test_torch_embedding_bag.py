"""Port parity: the EmbeddingBag wrapper against the JAX reference.

The same numpy inputs go to ``repro.kernels.embedding_bag`` (its Pallas
kernel in interpret mode, the JAX wrapper's default) and to
``repro_torch.kernels.embedding_bag`` on the CPU (the plain version), and
agree within atol 1e-5, the reference's own tolerance in
``tests/test_kernels.py``.  The kernel itself is held to its plain version
bit for bit on the card in ``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import embedding_bag as jembedding_bag
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref
from repro_torch.kernels import embedding_bag, launch_counts
from tests.hypcompat import given, settings, st

torch.set_num_threads(2)

TOL = 1e-5


def _assert_parity(table, idx, w=None, mask=None):
    args = [None if a is None else torch.as_tensor(a)
            for a in (table, idx, w, mask)]
    before = launch_counts()["embedding_bag"]
    out = embedding_bag(*args)
    assert launch_counts()["embedding_bag"] == before  # plain version ran
    assert out.dtype == args[0].dtype
    assert out.shape == (idx.shape[0], table.shape[1])
    jargs = [None if a is None else jnp.asarray(a)
             for a in (table, idx, w, mask)]
    jout = jembedding_bag(*jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL,
                               rtol=0)
    return out.numpy()


@pytest.mark.parametrize("nb,hot,V,dim", [(4, 2, 50, 8), (16, 8, 1000, 128),
                                          (33, 5, 200, 64)])
def test_embedding_bag_sweep_parity(nb, hot, V, dim):
    """The shapes of ``tests/test_kernels.py``'s sweep, with weights and a
    validity mask; also against the JAX gather-and-sum ``ref.py``."""
    rng = np.random.default_rng(nb * hot)
    table = rng.normal(size=(V, dim)).astype(np.float32)
    idx = rng.integers(0, V, (nb, hot)).astype(np.int32)
    w = rng.uniform(0, 1, (nb, hot)).astype(np.float32)
    mask = rng.random((nb, hot)) < 0.7
    out = _assert_parity(table, idx, w, mask)
    ref = jref(jnp.asarray(table), jnp.asarray(idx),
               jnp.asarray(w * mask.astype(np.float32)))
    np.testing.assert_allclose(out, np.asarray(ref), atol=TOL, rtol=0)


def test_embedding_bag_clips_ids():
    """Negative ids read row 0 and ids past the table its last row, as the
    JAX wrapper clips them."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=(37, 7)).astype(np.float32)
    idx = np.array([[-4, 0, 36], [37, 1000, -1], [5, 5, 5]], np.int32)
    out = _assert_parity(table, idx)
    np.testing.assert_allclose(out[1], table[36] * 2 + table[0], atol=TOL)


def test_embedding_bag_default_weights_and_mask_only():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    idx = rng.integers(0, 64, (9, 4)).astype(np.int32)
    mask = rng.random((9, 4)) < 0.5
    mask[0] = False                                   # an empty bag
    out = _assert_parity(table, idx, None, mask)
    assert np.array_equal(out[0], np.zeros(16, np.float32))
    _assert_parity(table, idx)


def test_embedding_bag_zero_weight_keeps_inf_times_zero_nan():
    """A zero-weight slot is multiplied, not skipped: inf * 0 is NaN."""
    table = np.ones((4, 3), np.float32)
    table[2, 1] = np.inf
    idx = np.array([[0, 2], [1, 3]], np.int32)
    w = np.array([[1.0, 0.0], [0.5, 0.5]], np.float32)
    out = embedding_bag(*map(torch.as_tensor, (table, idx, w))).numpy()
    jout = np.asarray(jembedding_bag(*map(jnp.asarray, (table, idx, w))))
    assert np.array_equal(np.isnan(out), np.isnan(jout))
    assert np.isnan(out[0, 1]) and not np.isnan(out[1]).any()
    np.testing.assert_allclose(out[~np.isnan(out)], jout[~np.isnan(jout)],
                               atol=TOL)


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 40), st.integers(1, 9))
def test_property_bag_any_shape_parity(seed, nb, hot):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    idx = rng.integers(-3, 67, (nb, hot)).astype(np.int32)
    w = rng.uniform(0, 1, (nb, hot)).astype(np.float32)
    _assert_parity(table, idx, w)
