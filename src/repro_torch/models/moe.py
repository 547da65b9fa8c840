"""Mixture-of-Experts FFN with grouped scatter dispatch (PyTorch port of
``repro.models.moe``).

Tokens are split into groups; within each group every token's top-k expert
choices get a slot in a per-(group, expert) capacity buffer via a cumsum
rank in token-major order (GShard priority), and dispatch/combine are
scatter/gather: O(T·k·d) data movement, not a one-hot dispatch product.
Expert compute is one batched product over the expert stack.  The aux
load-balance loss follows Switch (E · Σ_e f_e · p_e).

The router logits are float32 sums of exact products (``matmul_f32``), so
bf16 rounding cannot flip a routing choice; ``sorting.top_k`` puts the
lower expert first on ties, as ``lax.top_k`` does.  A dropped
(over-capacity) choice clamps to the last slot with a zeroed contribution,
so every valid slot is written once and the clamped adds are exact zeros:
the scatter-add gives the same bits in any order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _gelu_tanh, ffn, matmul_f32
from repro_torch.sorting import top_k


def _capacity(group_size: int, cfg: MoEConfig) -> int:
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)        # round up to 8


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
            w_out: torch.Tensor,
            shared: tuple[torch.Tensor, torch.Tensor] | None,
            cfg: MoEConfig, act: str, *, group_size: int = 4096,
            tokens_spec=None, experts_spec=None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux_loss float32 scalar).

    router_w: (d, E); w_in: (E, d, F·glu); w_out: (E, F, d);
    shared: optional (w_in_sh, w_out_sh) always-on expert.

    ``tokens_spec`` and ``experts_spec`` are the reference's sharding
    constraints on the token groups and the expert buffers; in one process
    they have no effect, and any value is accepted.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    gs = min(group_size, T)
    G = T // gs
    if G * gs != T:
        raise ValueError(f"{T} tokens do not split into groups of {gs}")
    C = _capacity(gs, cfg)

    xt = x.reshape(G, gs, d)
    logits = matmul_f32(xt.reshape(T, d),
                        router_w.to(x.dtype)).view(G, gs, E)
    probs = torch.softmax(logits, dim=-1)                 # (G, gs, E) fp32
    gates, eidx = top_k(probs, k)                         # (G, gs, k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)

    # Slot assignment: rank of each (token, choice) within its expert, in
    # token-major order, via a cumsum over the group.
    eflat = eidx.reshape(G, gs * k)
    onehot = F.one_hot(eflat, E)
    ranks = torch.cumsum(onehot, dim=1) - 1               # (G, gs·k, E)
    pos = torch.sum(ranks * onehot, dim=-1)               # (G, gs·k)
    valid = pos < C
    slot = torch.where(valid, eflat * C + torch.clamp_max(pos, C - 1),
                       E * C - 1)

    # Dispatch: scatter token activations into (G, E·C, d).
    gi = torch.arange(G, device=x.device)[:, None].expand(G, gs * k)
    xk = torch.repeat_interleave(xt, k, dim=1) * valid[..., None].to(x.dtype)
    buf = torch.zeros((G, E * C, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((gi, slot), xk, accumulate=True)

    # Expert compute: one batched product over the experts, (E, G·C, ·)
    # (the reference's einsums "gecd,edf" and "gecf,efd"; with one group
    # the layout changes are views, and the weights are never copied).
    be = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    h = torch.bmm(be, w_in.to(x.dtype))
    if act in ("swiglu", "geglu"):
        gate_h, up = torch.chunk(h, 2, dim=-1)
        inner = {"swiglu": F.silu, "geglu": _gelu_tanh}[act](gate_h) * up
    else:
        inner = _gelu_tanh(h)
    out_buf = torch.bmm(inner, w_out.to(x.dtype))
    out_buf = out_buf.reshape(E, G, C, d).transpose(0, 1).reshape(
        G, E * C, d)

    # Combine: gather each choice's output, weight by its gate (dropped
    # choices carry weight 0, so the clamped slot's contents never land).
    yk = out_buf[gi, slot]                                # (G, gs·k, d)
    w = (gates.reshape(G, gs * k) * valid).to(x.dtype)
    y = torch.sum(yk.reshape(G, gs, k, d) * w.reshape(G, gs, k, 1), dim=2)
    y = y.reshape(B, S, d)

    if shared is not None:
        y = y + ffn(x, shared[0], shared[1], act)

    # Switch load-balance aux: E · mean_e(f_e · p_e).
    frac = torch.mean(torch.sum(F.one_hot(eidx, E).float(), dim=2),
                      dim=(0, 1))                         # (E,) token fracs·k
    prob = torch.mean(probs, dim=(0, 1))                  # (E,)
    aux = E * torch.sum(frac / k * prob)
    return y, aux
