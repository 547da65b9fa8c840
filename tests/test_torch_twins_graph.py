"""Port parity: ``repro_torch.core.twins_graph`` against
``repro.core.twins_graph``: signatures and group ids exactly equal.

The reference's ``twin_groups`` runs as it can: with ``n_hash=1`` under
JAX's default 32-bit mode (a 32-bit key), and with ``n_hash=4`` only with
64-bit types enabled, inside a context manager so no other test sees
them.  Under the 32-bit default its ``n_hash=4`` key constant overflows
(``OverflowError``); that quirk is recorded here too.  The port always
builds the 64-bit key."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import twins_graph as jtg
from repro_torch.core import twins_graph as ttg

torch.set_num_threads(2)


def _x64():
    ctx = getattr(jax, "enable_x64", None)
    if ctx is None:                       # older releases
        from jax.experimental import enable_x64
        return enable_x64()
    return ctx(True)


def _graph(seed: int, n: int, e: int):
    """Random edges, then a few nodes given copies of other nodes'
    neighbour multisets (structural twins), edges shuffled."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    extra_src, extra_dst = [], []
    for a, b in rng.choice(n, size=(max(2, n // 8), 2), replace=False):
        nb = src[dst == a]
        extra_src.append(nb)
        extra_dst.append(np.full(nb.size, b, np.int32))
        keep = dst != b                    # b's own edges go
        src, dst = src[keep], dst[keep]
    src = np.concatenate([src, *extra_src]).astype(np.int32)
    dst = np.concatenate([dst, *extra_dst]).astype(np.int32)
    order = rng.permutation(src.size)
    return src[order], dst[order]


GRAPHS = [(0, 40, 120), (1, 200, 900), (2, 1000, 3000), (3, 64, 0 + 64)]


@pytest.mark.parametrize("n_hash", [1, 2, 3, 4])
@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_signature_matches_reference(seed, n, e, n_hash):
    src, dst = _graph(seed, n, e)
    want = np.asarray(jtg.adjacency_signature(jnp.asarray(dst),
                                              jnp.asarray(src), n, n_hash))
    got = ttg.adjacency_signature(torch.as_tensor(dst), torch.as_tensor(src),
                                  n, n_hash)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_signature_wraps_mod_2_32():
    """Enough edges into one node that the sums wrap: still equal."""
    src = np.arange(20_000, dtype=np.int32) % 997 + 2**20
    dst = np.zeros_like(src)
    want = np.asarray(jtg.adjacency_signature(jnp.asarray(dst),
                                              jnp.asarray(src), 3))
    got = ttg.adjacency_signature(torch.as_tensor(dst), torch.as_tensor(src),
                                  3)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_groups_n_hash_1_x32(seed, n, e):
    src, dst = _graph(seed, n, e)
    jsig = jtg.adjacency_signature(jnp.asarray(dst), jnp.asarray(src), n, 1)
    want = np.asarray(jtg.twin_groups(jsig))
    tsig = ttg.adjacency_signature(torch.as_tensor(dst),
                                   torch.as_tensor(src), n, 1)
    got = ttg.twin_groups(tsig)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed,n,e", GRAPHS)
def test_groups_n_hash_4_x64(seed, n, e):
    src, dst = _graph(seed, n, e)
    with _x64():
        jsig = jtg.adjacency_signature(jnp.asarray(dst), jnp.asarray(src),
                                       n, 4)
        want = np.asarray(jtg.twin_groups(jsig))
        jsig = np.asarray(jsig)
    tsig = ttg.adjacency_signature(torch.as_tensor(dst),
                                   torch.as_tensor(src), n, 4)
    np.testing.assert_array_equal(tsig.numpy(), jsig.astype(np.int64))
    got = ttg.twin_groups(tsig)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # Nodes given the same neighbour multiset share a group.
    assert got.unique().numel() < n


def test_groups_keys_past_2_63_sort_unsigned():
    """Keys with the top bit set sort after the others, as uint64."""
    sig = torch.tensor([[0xFFFFFFFF, 1], [1, 2], [0xFFFFFFFF, 1],
                        [0x80000000, 0]], dtype=torch.int64)
    with _x64():
        want = np.asarray(jtg.twin_groups(jnp.asarray(sig.numpy(),
                                                      jnp.uint32)))
    np.testing.assert_array_equal(ttg.twin_groups(sig).numpy(),
                                  want.astype(np.int64))


def test_reference_twin_groups_overflows_at_default_n_hash_in_x32():
    src, dst = _graph(0, 40, 120)
    sig = jtg.adjacency_signature(jnp.asarray(dst), jnp.asarray(src), 40)
    with pytest.raises(OverflowError):
        jtg.twin_groups(sig)
