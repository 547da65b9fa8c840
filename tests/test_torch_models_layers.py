"""Port parity of ``repro_torch.models.layers`` against
``repro.models.layers``: every function on the same numpy inputs (made
from a seed), within 1e-6; the initialisers by shape, dtype and scale
(their draws come from a ``torch.Generator``, not a JAX key)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as jl
from repro_torch.models import layers as tl

torch.set_num_threads(2)

TOL = 1e-6


def _close(got: torch.Tensor, want, tol: float = TOL) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max(initial=0.0) <= tol


def _x(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 32), (7,)])
def test_rms_norm(shape):
    x, s = _x(0, *shape), _x(1, shape[-1])
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(s)),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s)))
    _close(tl.rms_norm(torch.tensor(x), torch.tensor(s), eps=1e-3),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), eps=1e-3))


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 32)])
def test_layer_norm(shape):
    x, s, b = _x(2, *shape), _x(3, shape[-1]), _x(4, shape[-1])
    _close(tl.layer_norm(*map(torch.tensor, (x, s, b))),
           jl.layer_norm(*map(jnp.asarray, (x, s, b))))


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    x, w, b = _x(5, 4, 6, 16), _x(6, 16, 24), _x(7, 24)
    tb, jb = (torch.tensor(b), jnp.asarray(b)) if bias else (None, None)
    _close(tl.dense(torch.tensor(x), torch.tensor(w), tb),
           jl.dense(jnp.asarray(x), jnp.asarray(w), jb))


@pytest.mark.parametrize("name", ["gelu", "silu", "relu", "gelu_tanh",
                                  "leaky_relu"])
def test_act_fn(name):
    x = _x(8, 5, 33) * 3
    _close(tl.act_fn(name)(torch.tensor(x)), jl.act_fn(name)(jnp.asarray(x)))


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu",
                                 "silu"])
def test_ffn(act):
    glu = act in ("swiglu", "geglu")
    x = _x(9, 3, 4, 16)
    w_in = _x(10, 16, 64 if glu else 32) * 0.2
    w_out = _x(11, 32, 16) * 0.2
    args = (x, w_in, w_out)
    _close(tl.ffn(*map(torch.tensor, args), act),
           jl.ffn(*map(jnp.asarray, args), act))
    fn = "glu_ffn" if glu else "dense_ffn"
    _close(getattr(tl, fn)(*map(torch.tensor, args), act),
           getattr(jl, fn)(*map(jnp.asarray, args), act))


@pytest.mark.parametrize("head_dim,theta", [(8, 10_000.0), (64, 1e6),
                                            (16, 500.0)])
def test_rope_freqs(head_dim, theta):
    _close(tl.rope_freqs(head_dim, theta), jl.rope_freqs(head_dim, theta))


@pytest.mark.parametrize("shape", [(2, 7, 4, 16), (5, 2, 8)])
def test_apply_rope(shape):
    x = _x(12, *shape)
    pos = np.arange(shape[-3], dtype=np.int32) * 3
    if len(shape) == 4:
        pos = np.stack([pos, pos + 11])
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(pos), 10_000.0),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))


@pytest.mark.parametrize("shape", [(64, 32), (4096,), (3, 128, 16)])
def test_initialisers_shape_dtype_and_scale(shape):
    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = tl.normal_init(g, shape, 0.5, dtype)
        assert x.shape == shape and x.dtype == dtype
        assert abs(float(x.float().std()) - 0.5) < 0.1
        y = tl.fan_in_init(g, shape, dtype)
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        assert y.shape == shape and y.dtype == dtype
        assert abs(float(y.float().std()) * fan_in ** 0.5 - 1.0) < 0.2
    a = tl.normal_init(torch.Generator().manual_seed(3), shape, 1.0,
                       torch.float32)
    b = tl.normal_init(torch.Generator().manual_seed(3), shape, 1.0,
                       torch.float32)
    assert torch.equal(a, b)
    m = tl.fan_in_init(None, shape, torch.float32, device="meta")
    assert m.is_meta and m.shape == shape
