"""Port parity of ``repro_torch.models.attention`` against
``repro.models.attention``: ``gqa_attention`` on the same numpy inputs,
on the block path (Sk <= chunk) and the chunked path (chunk 8), for MQA,
GQA and MHA, with no window and a window of 4 (which masks whole KV
chunks for late queries), and the decode shape (Sq = 1) against a ring of
positions holding never-written (-1) slots.

Tolerances: float32 inputs within 2e-6 (the same float32 sums in another
order); bfloat16 inputs within 1e-2 + |reference|/64, two bf16 ulps (the
output is rounded to bf16, and the probabilities are rounded to bf16
before their product, on both sides).  The mask constant is -1e30 on both
sides, so wholly masked chunks stay finite: in float32 the chunked path at
window 4 agrees with the block path within 1e-6.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as jattn
from repro_torch.models import attention as tattn

torch.set_num_threads(2)

TOL = {"float32": (2e-6, 0.0), "bfloat16": (1e-2, 1 / 64)}
HEADS = {"mqa": (4, 1), "gqa": (4, 2), "mha": (4, 4)}


def _inputs(seed, B, Sq, Sk, Hq, Hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, Hkv, hd)).astype(np.float32)
    if dtype == "bfloat16":        # values a bf16 holds, so both sides agree
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v


def _run(q, k, v, qpos, kpos, dtype, **kw):
    jdt = getattr(jnp, dtype)
    want = jattn.gqa_attention(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(qpos), jnp.asarray(kpos), **kw)
    tdt = getattr(torch, dtype)
    got = tattn.gqa_attention(
        torch.tensor(q).to(tdt), torch.tensor(k).to(tdt),
        torch.tensor(v).to(tdt), torch.tensor(qpos), torch.tensor(kpos),
        **kw)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _close(got, want, dtype) -> bool:
    atol, rtol = TOL[dtype]
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("path,Sk,chunk", [("block", 16, 2048),
                                           ("chunked", 32, 8)])
def test_gqa_attention_matches_reference(path, Sk, chunk, heads, window,
                                         dtype):
    Hq, Hkv = HEADS[heads]
    q, k, v = _inputs(Sk + Hkv + (window or 0), 2, Sk, Sk, Hq, Hkv,
                      16, dtype)
    pos = np.arange(Sk, dtype=np.int32)
    got, want = _run(q, k, v, pos, pos, dtype, window=window, chunk=chunk)
    assert np.all(np.isfinite(got))
    assert _close(got, want, dtype)


def test_chunked_equals_block_with_masked_chunks():
    """At window 4 and chunk 8 every late query sees whole chunks masked;
    the -1e30 recurrence stays finite and agrees with the block path within
    1e-6 in float32."""
    q, k, v = _inputs(7, 1, 32, 32, 4, 1, 16, "float32")
    pos = torch.arange(32, dtype=torch.int32)
    args = [torch.tensor(a) for a in (q, k, v)]
    chunked = tattn.gqa_attention(*args, pos, pos, window=4, chunk=8)
    block = tattn.gqa_attention(*args, pos, pos, window=4, chunk=2048)
    assert torch.isfinite(chunked).all()
    assert (chunked - block).abs().max() <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("heads", sorted(HEADS))
def test_decode_against_a_ring_with_unwritten_slots(heads, window, dtype):
    """Sq = 1 at position 5 against an 8-slot ring: slots 6 and 7 were
    never written (-1), and with window 4 slots 0 and 1 are too old."""
    Hq, Hkv = HEADS[heads]
    q, k, v = _inputs(3, 3, 1, 8, Hq, Hkv, 16, dtype)
    kpos = np.array([0, 1, 2, 3, 4, 5, -1, -1], np.int32)
    qpos = np.array([5], np.int32)
    got, want = _run(q, k, v, qpos, kpos, dtype, window=window)
    assert _close(got, want, dtype)


def test_chunked_path_refuses_a_ragged_split():
    q = torch.zeros((1, 12, 4, 16))
    k = torch.zeros((1, 12, 1, 16))
    pos = torch.arange(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="chunks of 8"):
        tattn.gqa_attention(q, k, k, pos, pos, chunk=8)


def test_mask_and_constant_match_reference():
    assert tattn.NEG_INF == jattn.NEG_INF == -1e30
    qpos = np.array([0, 3, 7], np.int32)
    kpos = np.array([-1, 0, 2, 3, 5, 7], np.int32)
    for window in (None, 3):
        got = tattn._mask(torch.tensor(qpos), torch.tensor(kpos), window)
        want = jattn._mask(jnp.asarray(qpos), jnp.asarray(kpos), window)
        assert np.array_equal(got.numpy(), np.asarray(want))
