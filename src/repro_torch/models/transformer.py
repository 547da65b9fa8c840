"""Decoder-only LM family (PyTorch port of ``repro.models.transformer``):
dense + MoE, GQA/MQA, sliding-window/global mix.

Design points:
  * layer params are stacked (L, ...), as in the reference, and the blocks
    run in a Python loop over the layers.  Under autograd with
    ``cfg.remat`` each block runs under ``torch.utils.checkpoint``
    (non-reentrant): the reference's ``jax.checkpoint(nothing_saveable)``,
    which keeps only each block's input, so a full-width train step fits;
  * per-layer attention windows (``layer_windows``: W for local layers,
    ``GLOBAL_WINDOW`` for global ones) feed one mask expression;
  * the LM-head loss is computed in sequence chunks, each recomputed in the
    backward pass, so the (B, S, V) float32 logits never exist at once
    (vocab up to 262k);
  * decode is a layer loop with a ring-buffer cache (size W) for local
    layers and a full cache for global layers; it writes the new token's
    keys and values into the cache's tensors in place (the reference's
    decode cell donates the cache to the step).  It reads the position on
    the host (``int(pos)``), so a dry run (``launch.dryrun``), which traces
    on ``meta`` tensors that hold no data, passes it as a host int: the last
    position of the cell's cache;
  * ``LMShardingHooks`` are the reference's sharding constraints.  In one
    process ``acts``, ``logits``, ``moe_tokens`` and ``moe_experts`` have
    no effect; ``moe_ep`` (a ``models.moe_ep.MoEEPInfo``) routes the MoE
    layers through the expert-parallel ``moe_ffn_ep`` on its mesh's
    process groups, each rank passing its blocks of the activations and
    expert weights.

The embedding scale is rounded to the param dtype before it multiplies
(√1152 is 34.0 in bf16), and the unembedding is a float32 sum of exact
products (``layers.matmul_f32``), as in the reference.  ``init_params``
draws from a ``torch.Generator``; its numbers differ from ``jax.random``'s
for the same seed, so tests carry weights across with
``bridge.params_from_numpy``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LMConfig, ShapeSpec
from repro_torch.core.types import require_device
from repro_torch.models.attention import gqa_attention
from repro_torch.models.layers import (apply_rope, fan_in_init, ffn,
                                       matmul_f32, normal_init, rms_norm)
from repro_torch.models.moe import moe_ffn
from repro_torch.models.moe_ep import moe_ffn_ep

GLOBAL_WINDOW = 1 << 30


class LMShardingHooks(NamedTuple):
    """The reference's sharding constraints.  Without a mesh they have no
    effect, except ``moe_ep``, which selects ``moe_ffn_ep``."""

    acts: Any = None        # (B, S, d) between blocks
    logits: Any = None      # (B, chunk, V) inside the loss
    moe_tokens: Any = None  # (G, gs, d) token groups + dispatch buffer
    moe_experts: Any = None  # (G, E, C, f) expert-sharded buffers
    moe_ep: Any = None      # MoEEPInfo: expert parallelism (moe_ffn_ep)


def is_global_layer(cfg: LMConfig, layer: int) -> bool:
    if cfg.window is None:
        return True
    if cfg.global_every is None:
        return False
    return (layer + 1) % cfg.global_every == 0


def layer_windows(cfg: LMConfig) -> torch.Tensor:
    """(L,) int32 attention window per layer (sentinel = global), on the
    CPU."""
    return torch.tensor(
        [GLOBAL_WINDOW if is_global_layer(cfg, l) else cfg.window
         for l in range(cfg.n_layers)], dtype=torch.int32)


def _glu_factor(cfg: LMConfig) -> int:
    return 2 if cfg.act in ("swiglu", "geglu") else 1


def _as_dtype(dtype: str | torch.dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator | None, cfg: LMConfig,
                device: str | torch.device | None = None) -> dict:
    """Seeded random weights from ``gen``, on ``device`` (the generator's
    by default).  On the ``meta`` device nothing is drawn and ``gen`` may
    be None."""
    device = torch.device(device if device is not None else gen.device)
    dt = _as_dtype(cfg.dtype)
    d, L = cfg.d_model, cfg.n_layers
    gf = _glu_factor(cfg)

    def normal(shape, scale, dtype=dt):
        return normal_init(gen, shape, scale, dtype, device)

    def fan_in(shape):
        return fan_in_init(gen, shape, dt, device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers = {
        "attn_norm": zeros((L, d)),
        "mlp_norm": zeros((L, d)),
        "wq": fan_in((L, d, cfg.q_dim)),
        "wk": fan_in((L, d, cfg.kv_dim)),
        "wv": fan_in((L, d, cfg.kv_dim)),
        "wo": normal((L, cfg.q_dim, d), (cfg.q_dim ** -0.5) / (2 * L) ** 0.5),
    }
    if cfg.moe is not None:
        m = cfg.moe
        layers["router"] = normal((L, d, m.n_experts), d ** -0.5,
                                  torch.float32)
        layers["w_in_e"] = fan_in((L, m.n_experts, d, gf * m.d_ff_expert))
        layers["w_out_e"] = normal((L, m.n_experts, m.d_ff_expert, d),
                                   (m.d_ff_expert ** -0.5) / (2 * L) ** 0.5)
        if m.n_shared:
            layers["w_in_sh"] = fan_in((L, d, gf * m.n_shared *
                                        m.d_ff_expert))
            layers["w_out_sh"] = normal(
                (L, m.n_shared * m.d_ff_expert, d),
                (m.d_ff_expert ** -0.5) / (2 * L) ** 0.5)
    else:
        layers["w_in"] = fan_in((L, d, gf * cfg.d_ff))
        layers["w_out"] = normal((L, cfg.d_ff, d),
                                 (cfg.d_ff ** -0.5) / (2 * L) ** 0.5)
    params = {
        "embed": normal((cfg.vocab_size, d), 1.0),
        "layers": layers,
        "final_norm": zeros((d,)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = fan_in((d, cfg.vocab_size))
    return params


def param_structs(cfg: LMConfig) -> dict:
    """The params as ``meta`` tensors (shapes and dtypes, no data)."""
    return init_params(None, cfg, device="meta")


def _per_layer(layers: dict, n_layers: int) -> list[dict]:
    """Each layer's views of the stacked params.  ``unbind`` makes the
    backward one stack of the layers' gradients."""
    cols = {k: v.unbind(0) for k, v in layers.items()}
    return [{k: cols[k][l] for k in cols} for l in range(n_layers)]


def _call(fn, remat: bool, *args):
    """``fn(*args)``, under activation checkpointing when ``remat`` is set
    and autograd records."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Blocks / forward
# ---------------------------------------------------------------------------

def _attention_sublayer(x: torch.Tensor, lp: dict, cfg: LMConfig,
                        positions: torch.Tensor, win: int | None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(attention output (B, S, d), rotated keys, values)."""
    B, S, d = x.shape
    h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = torch.matmul(h, lp["wq"].to(h.dtype))
    k = torch.matmul(h, lp["wk"].to(h.dtype))
    v = torch.matmul(h, lp["wv"].to(h.dtype))
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = gqa_attention(q, k, v, positions, positions, window=win)
    out = out.reshape(B, S, cfg.q_dim)
    return torch.matmul(out, lp["wo"].to(out.dtype)), k, v


def _ffn_sublayer(x: torch.Tensor, lp: dict, cfg: LMConfig,
                  hooks: LMShardingHooks = LMShardingHooks()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
    if cfg.moe is not None:
        shared = ((lp["w_in_sh"], lp["w_out_sh"])
                  if cfg.moe.n_shared else None)
        if hooks.moe_ep is not None:
            y, aux = moe_ffn_ep(h, lp["router"], lp["w_in_e"],
                                lp["w_out_e"], cfg.moe, cfg.act,
                                hooks.moe_ep)
            if shared is not None:
                y = y + ffn(h, shared[0], shared[1], cfg.act)
            return y, aux
        return moe_ffn(h, lp["router"], lp["w_in_e"], lp["w_out_e"], shared,
                       cfg.moe, cfg.act, tokens_spec=hooks.moe_tokens,
                       experts_spec=hooks.moe_experts)
    return (ffn(h, lp["w_in"], lp["w_out"], cfg.act),
            torch.zeros((), dtype=torch.float32, device=x.device))


def _block(x: torch.Tensor, lp: dict, win: int, cfg: LMConfig,
           positions: torch.Tensor, hooks: LMShardingHooks):
    """One layer: (output, aux loss, the layer's keys and values)."""
    a, k, v = _attention_sublayer(x, lp, cfg, positions, win)
    x = x + a
    y, aux = _ffn_sublayer(x, lp, cfg, hooks)
    return x + y, aux, k, v


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: LMConfig
                 ) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # The scale rounded to the param dtype first, as the reference's
        # jnp.asarray(√d, x.dtype): 34.0, not 33.94, in bf16 at d = 1152.
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        x = x * scale
    return x


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            hooks: LMShardingHooks = LMShardingHooks()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (hidden (B, S, d) pre-final-norm, mean aux loss).
    (The reference's ``unroll``, a scan option for its dry-run, has no
    counterpart: the port's layer loop is Python.)"""
    S = tokens.shape[1]
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    auxs = []
    for lp, win in zip(_per_layer(params["layers"], cfg.n_layers),
                       layer_windows(cfg).tolist()):
        x, aux, _k, _v = _call(_block, cfg.remat, x, lp, win, cfg,
                               positions, hooks)
        auxs.append(aux)
    return x, torch.stack(auxs).mean()


def unembed_weight(params: dict, cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["unembed"]


def _chunk_loss(h: torch.Tensor, W: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Σ (logsumexp - gold logit)·mask over one (B, cs) chunk, from float32
    logits."""
    B, cs, d = h.shape
    logits = matmul_f32(h.reshape(B * cs, d), W.to(h.dtype)).view(B, cs, -1)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mask)


def lm_loss(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            hooks: LMShardingHooks = LMShardingHooks(),
            loss_chunk: int = 512) -> torch.Tensor:
    """Next-token cross entropy, computed in sequence chunks (each
    recomputed in the backward pass) so the full (B, S, V) logits tensor
    never exists."""
    B, S = tokens.shape
    h, aux = forward(params, tokens, cfg, hooks)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    W = unembed_weight(params, cfg)

    labels = torch.cat([tokens[:, 1:], torch.zeros((B, 1), dtype=tokens.dtype,
                                                   device=tokens.device)], 1)
    mask = (torch.arange(S, device=tokens.device) < S - 1).float()[None, :]

    cs = min(loss_chunk, S)
    n_chunks = S // cs
    if n_chunks * cs != S:
        raise ValueError(f"sequence {S} does not split into chunks of {cs}")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for j in range(n_chunks):
        sl = slice(j * cs, (j + 1) * cs)
        total = total + _call(_chunk_loss, True, h[:, sl], W, labels[:, sl],
                              mask[:, sl])
    loss = total / torch.clamp_min(torch.sum(mask) * B, 1.0)
    if cfg.moe is not None:
        loss = loss + cfg.moe.aux_loss_weight * aux
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def _global_local_split(cfg: LMConfig) -> tuple[list[int], list[int]]:
    g = [l for l in range(cfg.n_layers) if is_global_layer(cfg, l)]
    loc = [l for l in range(cfg.n_layers) if not is_global_layer(cfg, l)]
    return g, loc


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device = "cuda") -> dict:
    """Decode cache: a full (max_len) cache for global layers, a ring
    buffer (W) for local layers, plus the ring's written-position vector
    (-1 = never written), on ``device`` (the card unless the caller asks
    for the CPU or ``meta``)."""
    device = require_device(device, "init_cache")
    dt = _as_dtype(dtype or cfg.dtype)
    g, loc = _global_local_split(cfg)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = {"kg": torch.zeros((len(g), *shape), dtype=dt, device=device),
             "vg": torch.zeros((len(g), *shape), dtype=dt, device=device)}
    if loc:
        W = cfg.window
        ring = (len(loc), batch, W, cfg.n_kv_heads, cfg.head_dim)
        cache["kl"] = torch.zeros(ring, dtype=dt, device=device)
        cache["vl"] = torch.zeros(ring, dtype=dt, device=device)
        cache["ring_pos"] = torch.full((W,), -1, dtype=torch.int32,
                                       device=device)
    return cache


def cache_structs(cfg: LMConfig, batch: int, max_len: int) -> dict:
    """The decode cache as ``meta`` tensors."""
    return init_cache(cfg, batch, max_len, device="meta")


def _stack(xs: list[torch.Tensor], idx: list[int]) -> torch.Tensor:
    """``xs[idx]`` stacked on a new leading axis (length 0 if ``idx`` is
    empty)."""
    if idx:
        return torch.stack([xs[i] for i in idx])
    return xs[0].new_zeros((0, *xs[0].shape))


def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig,
            hooks: LMShardingHooks = LMShardingHooks()
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also returns the decode cache.
    Returns (last-position logits (B, V) float32, cache).

    The ring of the local layers holds positions S - W .. S - 1.  When
    S < W the first of them are negative: as in the reference, their slots
    take the keys that its indexing gives (a negative position wraps from
    the end, one still out of range clamps to the first key), and
    ``ring_pos`` records the negative positions, which the mask never
    reads."""
    B, S = tokens.shape
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ks, vs = [], []
    for lp, win in zip(_per_layer(params["layers"], cfg.n_layers),
                       layer_windows(cfg).tolist()):
        x, _aux, k, v = _call(_block, cfg.remat, x, lp, win, cfg, positions,
                              hooks)
        ks.append(k)
        vs.append(v)

    g, loc = _global_local_split(cfg)
    cache = {"kg": _stack(ks, g), "vg": _stack(vs, g)}
    if loc:
        W = cfg.window
        pos_tail = torch.arange(S - W, S, dtype=torch.int32, device=x.device)
        slots = (pos_tail % W).long()
        src = torch.where(pos_tail < 0, pos_tail + S, pos_tail).clamp(
            0, S - 1).long()
        ring_k = torch.zeros((len(loc), B, W, cfg.n_kv_heads, cfg.head_dim),
                             dtype=ks[0].dtype, device=x.device)
        ring_v = torch.zeros_like(ring_k)
        ring_k[:, :, slots] = torch.stack([ks[l][:, src] for l in loc])
        ring_v[:, :, slots] = torch.stack([vs[l][:, src] for l in loc])
        ring_pos = torch.zeros((W,), dtype=torch.int32, device=x.device)
        ring_pos[slots] = pos_tail
        cache.update(kl=ring_k, vl=ring_v, ring_pos=ring_pos)
    h_last = rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = matmul_f32(h_last, unembed_weight(params, cfg).to(h_last.dtype))
    return logits, cache


def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                pos: int | torch.Tensor, cfg: LMConfig,
                hooks: LMShardingHooks = LMShardingHooks()
                ) -> tuple[torch.Tensor, dict]:
    """One new token per sequence against the cache.

    tokens: (B, 1) int32; pos: the position being written (an int or a 0-d
    tensor).  Returns (logits (B, V) float32, cache).  The new keys and
    values, and ``ring_pos``, are written into ``cache``'s tensors in place;
    the returned dict holds the same tensors.  A position outside the
    global cache raises (the reference's update would clamp it onto the
    last slot).
    """
    pos = int(pos)
    S_max = cache["kg"].shape[2]
    if not 0 <= pos < S_max:
        raise ValueError(f"position {pos} outside the cache's {S_max}")
    B = tokens.shape[0]
    x = embed_tokens(params, tokens, cfg)                # (B, 1, d)
    dev = x.device
    qpos = torch.full((1,), pos, dtype=torch.int32, device=dev)
    g, loc = _global_local_split(cfg)
    g_of = {l: i for i, l in enumerate(g)}
    l_of = {l: i for i, l in enumerate(loc)}
    cache = dict(cache)
    if loc:
        W = cfg.window
        cache["ring_pos"][pos % W] = pos
    kpos = torch.arange(S_max, dtype=torch.int32, device=dev)

    for l, lp in enumerate(_per_layer(params["layers"], cfg.n_layers)):
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        q = torch.matmul(h, lp["wq"].to(h.dtype)).reshape(
            B, 1, cfg.n_heads, cfg.head_dim)
        k = torch.matmul(h, lp["wk"].to(h.dtype)).reshape(
            B, 1, cfg.n_kv_heads, cfg.head_dim)
        v = torch.matmul(h, lp["wv"].to(h.dtype)).reshape(
            B, 1, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, qpos, cfg.rope_theta)
        k = apply_rope(k, qpos, cfg.rope_theta)

        if is_global_layer(cfg, l):
            kc, vc = cache["kg"][g_of[l]], cache["vg"][g_of[l]]
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
            out = gqa_attention(q, kc, vc, qpos, kpos, window=None)
        else:
            kc, vc = cache["kl"][l_of[l]], cache["vl"][l_of[l]]
            kc[:, pos % W] = k[:, 0]
            vc[:, pos % W] = v[:, 0]
            out = gqa_attention(q, kc, vc, qpos, cache["ring_pos"],
                                window=cfg.window)
        x = x + torch.matmul(out.reshape(B, 1, cfg.q_dim),
                             lp["wo"].to(out.dtype))
        y, _aux = _ffn_sublayer(x, lp, cfg)
        x = x + y

    h_last = rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    logits = matmul_f32(h_last, unembed_weight(params, cfg).to(h_last.dtype))
    return logits, cache


# ---------------------------------------------------------------------------
# Cell inputs
# ---------------------------------------------------------------------------

def input_structs(cfg: LMConfig, shape: ShapeSpec) -> dict:
    """A cell's model inputs as ``meta`` tensors (shapes and dtypes)."""
    B = shape.dim("global_batch")
    S = shape.dim("seq_len")

    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        return {"tokens": meta((B, S))}
    if shape.kind == "decode":
        return {"cache": cache_structs(cfg, B, S), "tokens": meta((B, 1)),
                "pos": meta(())}
    raise ValueError(f"unknown LM shape kind {shape.kind}")
