"""Shared neural-net building blocks (PyTorch port of
``repro.models.layers``): plain functions on tensors, parameters as nested
dicts, in the reference's order of operations.

The initialisers take an explicit ``torch.Generator`` where the reference
takes a JAX key; the two give different numbers from the same seed, so
tests carry weights across with ``bridge.params_from_numpy``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm in fp32, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None
          ) -> torch.Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01
               ) -> torch.Tensor:
    """``jax.nn.leaky_relu``: slope 1 at x = 0, in value and gradient."""
    return torch.where(x >= 0, x, negative_slope * x)


# ``jax.nn.gelu`` approximates with tanh by default, so "gelu" does too.
_ACTS = {"gelu": _gelu_tanh, "silu": F.silu, "relu": F.relu,
         "gelu_tanh": _gelu_tanh, "leaky_relu": leaky_relu}


def act_fn(name: str):
    return _ACTS[name]


def glu_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
            act: str) -> torch.Tensor:
    """Gated FFN: w_in packs [gate | up] along its last axis."""
    gu = torch.matmul(x, w_in.to(x.dtype))
    gate, up = torch.chunk(gu, 2, dim=-1)
    inner = {"swiglu": F.silu, "geglu": _gelu_tanh}[act](gate) * up
    return torch.matmul(inner, w_out.to(x.dtype))


def dense_ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
              act: str = "gelu") -> torch.Tensor:
    h = act_fn(act)(torch.matmul(x, w_in.to(x.dtype)))
    return torch.matmul(h, w_out.to(x.dtype))


def ffn(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor, act: str
        ) -> torch.Tensor:
    if act in ("swiglu", "geglu"):
        return glu_ffn(x, w_in, w_out, act)
    return dense_ffn(x, w_in, w_out, act)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: str | torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)              # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator | None, shape: tuple[int, ...],
                scale: float, dtype: torch.dtype,
                device: str | torch.device | None = None) -> torch.Tensor:
    """N(0, scale²) drawn in fp32 from ``gen`` on the generator's device,
    then cast to ``dtype`` and moved to ``device`` (the generator's by
    default).  On the ``meta`` device it draws nothing and ``gen`` may be
    None."""
    device = torch.device(device) if device is not None else gen.device
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(scale).to(dtype).to(device)     # in place: tables are GBs


def fan_in_init(gen: torch.Generator | None, shape: tuple[int, ...],
                dtype: torch.dtype,
                device: str | torch.device | None = None) -> torch.Tensor:
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return normal_init(gen, shape, fan_in ** -0.5, dtype, device)


# ---------------------------------------------------------------------------
# Products with float32 output
# ---------------------------------------------------------------------------

class _MatmulF32(torch.autograd.Function):
    """``a @ b`` of low-precision operands with a float32 result: each
    product exact, the sums in float32.  On the card one cuBLAS call with a
    float32 output (``out_dtype``); on the CPU a product of float32 copies.
    The backward is JAX's transpose rule for such a product: the float32
    cotangent times the other operand in float32, cast to the operand's
    dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            op = torch.mm if a.dim() == 2 else torch.bmm
            return op(a, b, out_dtype=torch.float32)
        return torch.matmul(a.float(), b.float())

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().mT, g).to(b.dtype)
        return ga, gb


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as ``jnp.einsum(..., preferred_element_type=jnp.float32)``
    computes it: a float32 result whatever the operands' dtype, with no
    rounding of the sums to the operands' precision (a bf16 product would
    round each sum to bf16).  ``a`` and ``b`` are 2-D, or 3-D with the same
    batch size, and of one dtype."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _MatmulF32.apply(a, b)
