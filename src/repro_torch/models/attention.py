"""Grouped-query attention with causal/sliding-window masking (PyTorch port
of ``repro.models.attention``).

One implementation covers the three serving shapes:
  * train/prefill — an online-softmax loop over KV chunks (flash-style, so a
    32k prefill never materialises an S×S score matrix);
  * decode (Sq == 1) — a single block over the whole KV cache;
  * sliding-window layers — a position-derived band mask; decode uses a
    ring buffer of size W with an explicit written-position vector.

Positions are explicit int32 vectors so causal, windowed, ring-buffer and
padding semantics all reduce to one mask expression:
  valid = (kpos >= 0) & (kpos <= qpos) & (window is None | kpos > qpos - W).

The scores are float32 sums of the exact products of the (bf16) operands
(``layers.matmul_f32``), as the reference's ``preferred_element_type``
asks; the probability-value products return the operands' dtype.  Masked
scores are ``NEG_INF`` = -1e30, never ``-inf``: a KV chunk that is wholly
masked for a query then adds exp(0) = 1 per key to the running sums, and
the next chunk's correction exp(-1e30 - m) = 0 erases it, as in the
reference (with ``-inf`` the same step would compute ``-inf - -inf``).
Local layers compute every key and mask, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import matmul_f32

NEG_INF = -1e30


def _mask(qpos: torch.Tensor, kpos: torch.Tensor, window: int | None
          ) -> torch.Tensor:
    """(..., Sq, Sk) bool validity mask from position vectors."""
    q = qpos[..., :, None].to(torch.int32)
    k = kpos[..., None, :].to(torch.int32)
    ok = (k >= 0) & (k <= q)
    if window is not None:
        ok &= k > q - window
    return ok


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """einsum("bqhgd,bkhd->bhgqk") in float32.  q: (B,Sq,Hkv,G,hd); k:
    (B,Sk,Hkv,hd) -> (B,Hkv,G,Sq,Sk)."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    qb = q.permute(0, 2, 3, 1, 4).reshape(B * Hkv, G * Sq, hd)
    # (B·Hkv, Sk, hd) keeps hd innermost: a view for one KV head, else a
    # copy of whole rows; the product reads it transposed.
    kb = k.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd).transpose(1, 2)
    return matmul_f32(qb, kb).view(B, Hkv, G, Sq, Sk)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """einsum("bhgqk,bkhd->bqhgd") in v's dtype.  p: (B,Hkv,G,Sq,Sk); v:
    (B,Sk,Hkv,hd) -> (B,Sq,Hkv,G,hd)."""
    B, Hkv, G, Sq, Sk = p.shape
    hd = v.shape[-1]
    pb = p.reshape(B * Hkv, G * Sq, Sk)
    vb = v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, hd)
    return torch.bmm(pb, vb).view(B, Hkv, G, Sq, hd).permute(0, 3, 1, 2, 4)


def _block_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                qpos: torch.Tensor, kpos: torch.Tensor, window: int | None
                ) -> torch.Tensor:
    """Unchunked path. q: (B,Sq,Hkv,G,hd); k,v: (B,Sk,Hkv,hd)."""
    hd = q.shape[-1]
    scores = _scores(q, k) * (hd ** -0.5)
    scores = torch.where(_mask(qpos, kpos, window), scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return _pv(probs.to(v.dtype), v)


def _chunked_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, window: int | None,
                  chunk: int) -> torch.Tensor:
    """Online-softmax loop over KV chunks (the flash-attention recurrence),
    in the reference's order of operations."""
    B, Sq, Hkv, G, hd = q.shape
    Sk = k.shape[1]
    n_chunks = Sk // chunk
    if n_chunks * chunk != Sk:
        raise ValueError(f"{Sk} keys do not split into chunks of {chunk}")
    scale = hd ** -0.5
    acc = torch.zeros((B, Sq, Hkv, G, hd), dtype=torch.float32,
                      device=q.device)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=q.device)
    for j in range(n_chunks):
        sl = slice(j * chunk, (j + 1) * chunk)
        kj, vj = k[:, sl], v[:, sl]
        s = _scores(q, kj) * scale
        s = torch.where(_mask(qpos, kpos[sl], window), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))           # (B,Hkv,G,Sq)
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = _pv(p.to(vj.dtype), vj)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    denom = torch.clamp_min(l, 1e-30).permute(0, 3, 1, 2)[..., None]
    return acc / denom


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  qpos: torch.Tensor, kpos: torch.Tensor, *,
                  window: int | None = None, chunk: int = 2048
                  ) -> torch.Tensor:
    """q: (B,Sq,Hq,hd); k,v: (B,Sk,Hkv,hd); returns (B,Sq,Hq,hd).

    ``qpos``/``kpos``: (Sq,)/(Sk,) absolute positions (-1 = invalid slot).
    The block path serves ``Sq == 1`` and ``Sk <= chunk``; otherwise the
    keys are taken ``chunk`` at a time, and ``Sk`` must be a multiple of
    ``chunk``.  (The reference's ``unroll``, a scan option for its dry-run,
    has no counterpart: the port's loop is Python.)
    """
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, G, hd)
    if Sq == 1 or k.shape[1] <= chunk:
        out = _block_attn(qg, k, v, qpos, kpos, window)
    else:
        out = _chunked_attn(qg, k, v, qpos, kpos, window, chunk)
    return out.reshape(B, Sq, Hq, hd).to(q.dtype)
