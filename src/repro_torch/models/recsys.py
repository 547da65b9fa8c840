"""Recsys family: BST, xDeepFM (CIN), AutoInt, two-tower retrieval
(PyTorch port of ``repro.models.recsys``).

All four share the embedding substrate (``repro_torch.models.embedding``):
huge concatenated id tables feeding a small dense interaction network.  The
CTR models (BST / xDeepFM / AutoInt) emit a logit trained with BCE; the
two-tower model trains with in-batch sampled softmax and serves both
pairwise scoring and 1M-candidate retrieval (one matmul + top-k).

Parameters are nested dicts of tensors with the reference's keys and
shapes, so ``bridge.params_from_numpy`` carries JAX weights across.  The
dense products are ``torch.matmul``/``einsum`` in fp32 (TF32 off), as the
reference leaves them to XLA outside any Pallas kernel; xDeepFM's
multi-hot bag goes through the ``embedding_bag`` kernel on the card.
``input_structs`` describes a step's inputs as ``meta`` tensors.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import RecsysConfig, ShapeSpec
from repro_torch.core.similarity import _fp32_exact
from repro_torch.models import embedding as emb
from repro_torch.models.layers import fan_in_init, leaky_relu, normal_init
from repro_torch.sorting import top_k as _top_k
from repro_torch.tree import leaves

# Multi-hot bag attached to field 0 of the CTR models (exercises the
# EmbeddingBag path; e.g. "recent categories" list feature).
MULTI_HOT = 8


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------

def _mlp_params(gen, dims: tuple[int, ...], d_in: int, dt, device,
                d_out: int | None = 1) -> list[dict]:
    layers = []
    prev = d_in
    for d in dims:
        layers.append({"w": fan_in_init(gen, (prev, d), dt, device),
                       "b": torch.zeros((d,), dtype=dt, device=device)})
        prev = d
    if d_out is not None:
        layers.append({"w": fan_in_init(gen, (prev, d_out), dt, device),
                       "b": torch.zeros((d_out,), dtype=dt, device=device)})
    return layers


def _mlp(x: torch.Tensor, layers: list[dict], act=F.relu,
         final_act: bool = False) -> torch.Tensor:
    for i, lp in enumerate(layers):
        x = torch.matmul(x, lp["w"].to(x.dtype)) + lp["b"].to(x.dtype)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def _bias0(x: torch.Tensor) -> torch.Tensor:
    """The reference's constant zero bias of a one-output head."""
    return torch.zeros((1,), dtype=x.dtype, device=x.device)


def bce_with_logits(logit: torch.Tensor, label: torch.Tensor
                    ) -> torch.Tensor:
    """Mean BCE on logits.  At a logit of exactly 0 (the launcher's start
    from zeros) the reference's gradient is -y, not sigmoid(0) - y:
    ``jnp.maximum`` splits the gradient of a tie in half and ``jnp.abs``
    has slope 1 at 0.  ``torch.maximum`` splits ties the same way and the
    ``where`` below has slope 1 at 0, so the port's gradient is the
    reference's there too (ROADMAP, reference quirks)."""
    z, y = logit.float(), label.float()
    abs_z = torch.where(z >= 0, z, -z)
    per = (torch.maximum(z, torch.zeros_like(z)) - z * y
           + torch.log1p(torch.exp(-abs_z)))
    return torch.mean(per)


def field_offsets_np(cfg: RecsysConfig) -> np.ndarray:
    return emb.field_offsets(cfg.field_vocab_sizes)


def _ctr_embed(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """(B, n_sparse, dim) field embeddings (+ multi-hot bag into field 0)."""
    offs = field_offsets_np(cfg)
    e = emb.lookup(params["table"], batch["sparse_idx"], offs)
    if "multi_idx" in batch:
        bag = emb.embedding_bag(params["table"],
                                batch["multi_idx"][:, None, :],
                                batch["multi_mask"][:, None, :])
        e = torch.cat([e[:, :1] + bag.to(e.dtype), e[:, 1:]], dim=1)
    return e


def _dtype(cfg: RecsysConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------

def _init_xdeepfm(gen, cfg: RecsysConfig, dt, device) -> dict:
    m, D = cfg.n_sparse, cfg.embed_dim
    table = emb.init_table(gen, cfg.field_vocab_sizes, D, dt, device=device)
    lin_table = emb.init_table(gen, cfg.field_vocab_sizes, 1, dt,
                               device=device)
    dense_w = fan_in_init(gen, (cfg.n_dense, 1), dt, device)
    cin_ws, prev = [], m
    for h in cfg.cin_layers:
        cin_ws.append(fan_in_init(gen, (prev * m, h), dt, device))
        prev = h
    return {
        "table": table,
        "lin_table": lin_table,
        "dense_w": dense_w,
        "cin": cin_ws,
        "cin_out": fan_in_init(gen, (int(sum(cfg.cin_layers)), 1), dt,
                               device),
        "dnn": _mlp_params(gen, cfg.mlp_dims, m * D + cfg.n_dense, dt,
                           device),
    }


def _fwd_xdeepfm(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    e = _ctr_embed(params, batch, cfg)                   # (B, m, D)
    B, m, D = e.shape
    dense = batch["dense"].to(e.dtype)
    # linear (wide) branch
    lin = torch.sum(emb.lookup(params["lin_table"], batch["sparse_idx"],
                               field_offsets_np(cfg))[..., 0], dim=1)
    lin = lin + _mlp(dense, [{"w": params["dense_w"],
                              "b": _bias0(e)}])[..., 0]
    # CIN branch, held as (B, D, H): the outer product's channels
    # (h-major, as the reference's reshape) land contiguous for one GEMM,
    # and no transposed copy of the (B, H·m, D) intermediate is made.
    x0 = e.transpose(1, 2)                               # (B, D, m)
    xk, pooled = x0, []
    for W in params["cin"]:
        z = (xk[:, :, :, None] * x0[:, :, None, :]).reshape(B, D, -1)
        xk = torch.matmul(z, W.to(e.dtype))              # (B, D, H_k)
        pooled.append(torch.sum(xk, dim=1))              # (B, H_k)
    cin_logit = _mlp(torch.cat(pooled, dim=-1),
                     [{"w": params["cin_out"], "b": _bias0(e)}])[..., 0]
    # DNN branch
    dnn_in = torch.cat([e.reshape(B, m * D), dense], dim=-1)
    dnn_logit = _mlp(dnn_in, params["dnn"])[..., 0]
    return lin.float() + cin_logit.float() + dnn_logit.float()


# ---------------------------------------------------------------------------
# AutoInt
# ---------------------------------------------------------------------------

def _init_autoint(gen, cfg: RecsysConfig, dt, device) -> dict:
    D, A = cfg.embed_dim, cfg.d_attn
    table = emb.init_table(gen, cfg.field_vocab_sizes, D, dt, device=device)
    dense_emb = normal_init(gen, (cfg.n_dense, D), D ** -0.5, dt, device)
    n_tok = cfg.n_sparse + cfg.n_dense
    out = fan_in_init(gen, (n_tok * A, 1), dt, device)
    layers, d_in = [], D
    for _ in range(cfg.n_attn_layers):
        layers.append({name: fan_in_init(gen, (d_in, A), dt, device)
                       for name in ("wq", "wk", "wv", "wr")})
        d_in = A
    return {"table": table, "dense_emb": dense_emb, "attn": layers,
            "out": out}


def _attention(q, k, v, n_heads: int) -> torch.Tensor:
    """Softmax attention over the token axis of (B, T, A) projections, with
    ``n_heads`` heads; fp32 scores, as the reference's
    ``preferred_element_type``."""
    B, T, A = q.shape
    hd = A // n_heads
    q, k, v = (t.reshape(B, T, n_heads, hd) for t in (q, k, v))
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * hd ** -0.5
    a = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", a, v).reshape(B, T, A)


def _fwd_autoint(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    e = _ctr_embed(params, batch, cfg)                   # (B, m, D)
    dense_tok = batch["dense"].to(e.dtype)[..., None] * \
        params["dense_emb"].to(e.dtype)[None]            # (B, 13, D)
    x = torch.cat([e, dense_tok], dim=1)                 # (B, T, D)
    for lp in params["attn"]:
        q, k, v, res = (torch.matmul(x, lp[n].to(x.dtype))
                        for n in ("wq", "wk", "wv", "wr"))
        x = F.relu(_attention(q, k, v, cfg.n_attn_heads) + res)
    B = x.shape[0]
    return _mlp(x.reshape(B, -1), [{"w": params["out"], "b": _bias0(x)}]
                )[..., 0].float()


# ---------------------------------------------------------------------------
# BST (Behavior Sequence Transformer)
# ---------------------------------------------------------------------------

def _init_bst(gen, cfg: RecsysConfig, dt, device) -> dict:
    D = cfg.embed_dim
    seq = cfg.seq_len + 1                                # history + target
    item_table = emb.init_table(gen, (cfg.item_vocab,), D, dt,
                                device=device)
    pos_emb = normal_init(gen, (seq, D), D ** -0.5, dt, device)
    other_table = emb.init_table(gen, cfg.field_vocab_sizes, D, dt,
                                 device=device)
    blocks = []
    for _ in range(cfg.n_blocks):
        shapes = {"wq": (D, D), "wk": (D, D), "wv": (D, D), "wo": (D, D),
                  "ffn_in": (D, 4 * D), "ffn_out": (4 * D, D)}
        blocks.append({n: fan_in_init(gen, s, dt, device)
                       for n, s in shapes.items()})
    d_flat = seq * D + cfg.n_sparse * D
    return {
        "item_table": item_table,
        "pos_emb": pos_emb,
        "other_table": other_table,
        "blocks": blocks,
        "mlp": _mlp_params(gen, cfg.mlp_dims, d_flat, dt, device),
    }


def _fwd_bst(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    seq_ids = torch.cat([batch["hist"], batch["target"][:, None]], dim=1)
    x = params["item_table"][seq_ids.long()]             # (B, S+1, D)
    x = x + params["pos_emb"].to(x.dtype)[None]
    B, S, D = x.shape
    for bp in params["blocks"]:
        q, k, v = (torch.matmul(x, bp[n].to(x.dtype))
                   for n in ("wq", "wk", "wv"))
        o = _attention(q, k, v, cfg.n_heads)
        x = x + torch.matmul(o, bp["wo"].to(x.dtype))
        h = leaky_relu(torch.matmul(x, bp["ffn_in"].to(x.dtype)))
        x = x + torch.matmul(h, bp["ffn_out"].to(x.dtype))
    other = emb.lookup(params["other_table"], batch["sparse_idx"],
                       field_offsets_np(cfg))            # (B, F, D)
    flat = torch.cat([x.reshape(B, -1), other.reshape(B, -1)], dim=-1)
    return _mlp(flat, params["mlp"], act=leaky_relu)[..., 0].float()


# ---------------------------------------------------------------------------
# Two-tower retrieval
# ---------------------------------------------------------------------------

_ID_DIM = 128
_FIELD_DIM = 32
_N_USER_FIELDS = 4
_N_ITEM_FIELDS = 2


def _init_two_tower(gen, cfg: RecsysConfig, dt, device) -> dict:
    u_in = _ID_DIM + _N_USER_FIELDS * _FIELD_DIM
    i_in = _ID_DIM + _N_ITEM_FIELDS * _FIELD_DIM
    return {
        "user_table": emb.init_table(gen, (cfg.user_vocab,), _ID_DIM, dt,
                                     device=device),
        "item_table": emb.init_table(gen, (cfg.item_vocab,), _ID_DIM, dt,
                                     device=device),
        "field_table": emb.init_table(gen, cfg.field_vocab_sizes,
                                      _FIELD_DIM, dt, device=device),
        "user_mlp": _mlp_params(gen, cfg.tower_mlp[:-1], u_in, dt, device,
                                d_out=cfg.tower_mlp[-1]),
        "item_mlp": _mlp_params(gen, cfg.tower_mlp[:-1], i_in, dt, device,
                                d_out=cfg.tower_mlp[-1]),
        "log_tau": torch.zeros((), dtype=torch.float32, device=device),
    }


def _tower(x: torch.Tensor, layers: list[dict]) -> torch.Tensor:
    h = _mlp(x, layers)
    n = torch.linalg.vector_norm(h.float(), dim=-1, keepdim=True)
    return h / torch.clamp_min(n, 1e-6).to(h.dtype)


def user_embed(params, user_id, user_fields, cfg: RecsysConfig
               ) -> torch.Tensor:
    offs = field_offsets_np(cfg)[:_N_USER_FIELDS]
    uid = params["user_table"][user_id.long()]
    uf = emb.lookup(params["field_table"], user_fields, offs)
    x = torch.cat([uid, uf.reshape(uf.shape[0], -1)], dim=-1)
    return _tower(x, params["user_mlp"])


def item_embed(params, item_id, item_fields, cfg: RecsysConfig
               ) -> torch.Tensor:
    offs = field_offsets_np(cfg)[_N_USER_FIELDS:
                                 _N_USER_FIELDS + _N_ITEM_FIELDS]
    iid = params["item_table"][item_id.long()]
    itf = emb.lookup(params["field_table"], item_fields, offs)
    x = torch.cat([iid, itf.reshape(itf.shape[0], -1)], dim=-1)
    return _tower(x, params["item_mlp"])


def _fwd_two_tower(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """Pairwise scores (serve kind)."""
    u = user_embed(params, batch["user_id"], batch["user_fields"], cfg)
    i = item_embed(params, batch["item_id"], batch["item_fields"], cfg)
    return torch.sum(u.float() * i.float(), dim=-1)


def two_tower_loss(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """In-batch sampled softmax (Yi et al. RecSys'19; logQ correction is a
    no-op under the synthetic uniform negatives and is omitted)."""
    _fp32_exact(leaves(params)[0])
    u = user_embed(params, batch["user_id"], batch["user_fields"], cfg)
    i = item_embed(params, batch["item_id"], batch["item_fields"], cfg)
    tau = torch.exp(params["log_tau"]) + 0.05
    logits = torch.matmul(u.float(), i.float().T) / tau
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def retrieve(params, batch, cfg: RecsysConfig, top_k: int = 100
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """1 query vs n_candidates: one matmul + top-k, lower index first on
    ties as ``lax.top_k``.  Returns (scores f32, candidate positions
    int32), each (n_queries, top_k)."""
    _fp32_exact(leaves(params)[0])
    u = user_embed(params, batch["user_id"], batch["user_fields"], cfg)
    iemb = item_embed(params, batch["cand_ids"], batch["cand_fields"], cfg)
    scores = torch.matmul(u.float(), iemb.float().T)
    vals, idx = _top_k(scores, top_k)
    return vals, idx.to(torch.int32)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

_INIT = {"xdeepfm": _init_xdeepfm, "autoint": _init_autoint,
         "bst": _init_bst, "two_tower": _init_two_tower}
_FWD = {"xdeepfm": _fwd_xdeepfm, "autoint": _fwd_autoint, "bst": _fwd_bst,
        "two_tower": _fwd_two_tower}


def init_params(gen: torch.Generator | None, cfg: RecsysConfig,
                device: str | torch.device | None = None) -> dict:
    """Seeded random weights from ``gen``, on ``device`` (the generator's
    by default; a CPU generator's draws are copied to a card).  On the
    ``meta`` device nothing is drawn and ``gen`` may be None."""
    if device is None:
        device = gen.device
    return _INIT[cfg.variant](gen, cfg, _dtype(cfg), torch.device(device))


def forward(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    _fp32_exact(leaves(params)[0])
    return _FWD[cfg.variant](params, batch, cfg)


def loss(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    if cfg.variant == "two_tower":
        return two_tower_loss(params, batch, cfg)
    return bce_with_logits(forward(params, batch, cfg), batch["label"])


def input_structs(cfg: RecsysConfig, shape: ShapeSpec) -> dict[str, Any]:
    """A step's inputs as ``meta`` tensors (shapes and dtypes, no data)."""
    f32, i32 = torch.float32, torch.int32

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    B = shape.dim("batch")
    if cfg.variant == "two_tower":
        if shape.kind == "retrieval":
            C = shape.dim("n_candidates")
            return {
                "user_id": meta((B,), i32),
                "user_fields": meta((B, _N_USER_FIELDS), i32),
                "cand_ids": meta((C,), i32),
                "cand_fields": meta((C, _N_ITEM_FIELDS), i32),
            }
        d = {
            "user_id": meta((B,), i32),
            "user_fields": meta((B, _N_USER_FIELDS), i32),
            "item_id": meta((B,), i32),
            "item_fields": meta((B, _N_ITEM_FIELDS), i32),
        }
        if shape.kind == "train":
            d["label"] = meta((B,), f32)
        return d

    if shape.kind == "retrieval":
        # CTR models score 1M candidate items under one user context by
        # broadcasting the user/context fields.
        B = shape.dim("n_candidates")
    d: dict[str, Any] = {"sparse_idx": meta((B, cfg.n_sparse), i32)}
    if cfg.n_dense:
        d["dense"] = meta((B, cfg.n_dense), f32)
    if cfg.variant == "xdeepfm":
        d["multi_idx"] = meta((B, MULTI_HOT), i32)
        d["multi_mask"] = meta((B, MULTI_HOT), torch.bool)
    if cfg.variant == "bst":
        d["hist"] = meta((B, cfg.seq_len), i32)
        d["target"] = meta((B,), i32)
    if shape.kind == "train":
        d["label"] = meta((B,), f32)
    return d
