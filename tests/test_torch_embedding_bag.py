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


def _jax_weights(idx, w, mask):
    """The JAX wrapper's weight steps, in jnp: ones by default, times the
    mask in the weights' dtype, then float32."""
    weights = (jnp.ones(idx.shape, jnp.float32) if w is None
               else jnp.asarray(w))
    if mask is not None:
        weights = weights * jnp.asarray(mask).astype(weights.dtype)
    return weights.astype(jnp.float32)


def _assert_bitwise_jref(out, table, idx, w, mask):
    """Bit for bit against the JAX ``ref.py`` on the clipped ids and the
    JAX wrapper's weights (its sum over hot <= 17 is in serial order, as
    the port's; NaN where it has NaN)."""
    ids = jnp.clip(jnp.asarray(idx).astype(jnp.int32), 0, table.shape[0] - 1)
    ref = np.asarray(jref(jnp.asarray(table), ids, _jax_weights(idx, w,
                                                                mask)))
    assert np.array_equal(np.isnan(out), np.isnan(ref))
    fin = ~np.isnan(ref)
    assert np.array_equal(out[fin].view(np.uint32), ref[fin].view(np.uint32))


@pytest.mark.parametrize("wdtype", [None, np.float32, np.float16,
                                    np.float64])
@pytest.mark.parametrize("mdtype", [None, np.bool_, np.float32])
def test_embedding_bag_weight_and_mask_forms(wdtype, mdtype):
    """No weights, weights of float32 and of other dtypes, with no mask, a
    bool mask or a float mask: the forms the card takes in the kernel
    (float32 or no weights, bool or no mask) and those it multiplies on
    the host first.  Against the JAX wrapper within TOL, and bit for bit
    against the JAX ``ref.py``."""
    rng = np.random.default_rng(17)
    table = rng.normal(size=(90, 10)).astype(np.float32)
    idx = rng.integers(0, 90, (23, 8)).astype(np.int32)
    w = None if wdtype is None else rng.uniform(-2, 2, (23, 8)).astype(
        wdtype)
    mask = None if mdtype is None else (rng.random((23, 8)) < 0.6).astype(
        mdtype)
    out = _assert_parity(table, idx, w, mask)
    _assert_bitwise_jref(out, table, idx, w, mask)


@pytest.mark.parametrize("idtype", [np.int32, np.int64])
def test_embedding_bag_ids_out_of_range_and_int64(idtype):
    """Ids below 0 and at or past V, and int64 ids past the int32 range:
    cast to int32 first (wrapping as jnp does), then clipped."""
    rng = np.random.default_rng(5)
    table = rng.normal(size=(41, 6)).astype(np.float32)
    idx = rng.integers(-50, 100, (12, 4)).astype(idtype)
    idx[0] = [-1, 0, 40, 41]
    if idtype == np.int64:
        idx[1] = [2**32 + 5, -2**33 - 1, 2**31, 2**40 + 40]
    w = rng.uniform(0, 1, (12, 4)).astype(np.float32)
    mask = rng.random((12, 4)) < 0.7
    out = _assert_parity(table, idx, w, mask)
    _assert_bitwise_jref(out, table, idx, w, mask)
    if idtype == np.int64:                       # wraps to 5, -1, -2^31, 40
        want = (table[5] * w[1, 0] * mask[1, 0] + table[0] * w[1, 1]
                * mask[1, 1])
        assert np.allclose(out[1] - (table[0] * w[1, 2] * mask[1, 2]
                                     + table[40] * w[1, 3] * mask[1, 3]),
                           want, atol=TOL)


@pytest.mark.parametrize("with_mask", [False, True])
def test_embedding_bag_nan_and_inf_in_table(with_mask):
    """NaN and +-inf table entries, behind live, zero-weight and masked
    slots: NaN where the JAX wrapper has NaN, the rest within TOL, and bit
    for bit against the JAX ``ref.py``."""
    rng = np.random.default_rng(9)
    table = rng.normal(size=(30, 9)).astype(np.float32)
    table[3, 2] = np.nan
    table[4, 0] = np.inf
    table[5, 8] = -np.inf
    idx = rng.integers(0, 30, (16, 8)).astype(np.int32)
    idx[:, 0] = [3, 4, 5, 6] * 4
    w = rng.uniform(0, 1, (16, 8)).astype(np.float32)
    w[::3, 0] = 0.0                              # inf * 0 is NaN
    mask = rng.random((16, 8)) < 0.5 if with_mask else None
    args = [None if a is None else torch.as_tensor(a)
            for a in (table, idx, w, mask)]
    out = embedding_bag(*args).numpy()
    jout = np.asarray(jembedding_bag(*[None if a is None else jnp.asarray(a)
                                       for a in (table, idx, w, mask)]))
    assert np.array_equal(np.isnan(out), np.isnan(jout))
    assert np.isnan(out).any() and np.isinf(out).any()
    fin = ~np.isnan(out)
    np.testing.assert_allclose(out[fin], jout[fin], atol=TOL, rtol=0)
    _assert_bitwise_jref(out, table, idx, w, mask)


@pytest.mark.parametrize("case", ["cpu", "w_dtype", "mask_dtype", "w_shape",
                                  "mask_shape", "idx_dtype", "table_dtype",
                                  "layout"])
def test_kernel_binding_refuses_before_launch(case):
    """``embedding_bag_cuda`` checks shapes, dtypes, the layout and the
    device in Python, before any pointer reaches the kernel."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    table = torch.zeros((5, 4))
    idx = torch.zeros((3, 2), dtype=torch.int32)
    w = torch.ones((3, 2))
    mask = torch.ones((3, 2), dtype=torch.bool)
    kw = {}
    if case == "w_dtype":
        w = w.double()
    elif case == "mask_dtype":
        mask = mask.float()
    elif case == "w_shape":
        w = w[:2]
    elif case == "mask_shape":
        mask = mask[:, :1]
    elif case == "idx_dtype":
        idx = idx.long()
    elif case == "table_dtype":
        table = table.half()
    elif case == "layout":
        kw["layout"] = "rows"
    error = ValueError if case in ("cpu", "w_shape", "mask_shape",
                                   "layout") else TypeError
    before = launch_counts()["embedding_bag"]
    with pytest.raises(error):
        embedding_bag_cuda(table, idx, w, mask, **kw)
    assert launch_counts()["embedding_bag"] == before
