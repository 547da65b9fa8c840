"""Sparse-embedding substrate of the recsys family (PyTorch port of
``repro.models.embedding``).

One concatenated table per model (fields laid out back to back with static
offsets), plain indexing for one-hot fields, and a weighted bag sum for
multi-hot bags.  ``embedding_bag`` runs the hand-written ``embedding_bag``
kernel on a CUDA float32 table (``kernels.embedding_bag.ops``) and its
plain version on a CPU table; any other dtype on the card raises there.
Row sharding is named by ``distributed.sharding.recsys_shardings``.

The kernel clips ids to ``[0, V - 1]`` where the reference's ``jnp.take``
fills an out-of-range gather with NaN; the models' ids are always in range
(ROADMAP, reference quirks).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import pad_to_shard
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models.layers import normal_init


def field_offsets(vocab_sizes: tuple[int, ...]) -> np.ndarray:
    """Static start offset of each field inside the concatenated table."""
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def init_table(gen: torch.Generator | None, vocab_sizes: tuple[int, ...],
               dim: int, dtype: torch.dtype = torch.float32,
               scale: float | None = None,
               device: str | torch.device | None = None) -> torch.Tensor:
    """Rows padded to the 512 shard boundary (``configs.base.pad_to_shard``)
    so row-sharding over any rank count that divides 512 is even."""
    total = pad_to_shard(int(sum(vocab_sizes)))
    return normal_init(gen, (total, dim), scale or dim ** -0.5, dtype, device)


_OFFSETS: dict = {}


def _offsets_on(offsets: np.ndarray, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """``offsets`` as a ``dtype`` tensor on ``device``, copied there once
    per (values, dtype, device): a copy in every call would put a
    synchronising host-to-device copy into every forward."""
    offsets = np.asarray(offsets)
    key = (offsets.tobytes(), offsets.dtype.str, dtype, str(device))
    t = _OFFSETS.get(key)
    if t is None:
        t = _OFFSETS[key] = torch.as_tensor(offsets, dtype=dtype,
                                            device=device)
    return t


def lookup(table: torch.Tensor, idx: torch.Tensor,
           offsets: np.ndarray) -> torch.Tensor:
    """One-hot fields: idx (..., F) of per-field ids -> (..., F, dim)."""
    return table[idx.long() + _offsets_on(offsets, torch.long, idx.device)]


class _BagSum(torch.autograd.Function):
    """Σ_h mask[b, h]·table[idx[b, h]] over (n_bags, hot) bags; a mask that
    is not bool weighs each slot, as the reference's ``mask.astype``.

    Forward is ``kernels.embedding_bag.ops.embedding_bag`` with the mask
    (or weights) passed in: one kernel launch on a CUDA float32 table, the
    plain version on a CPU table.  Backward scatter-adds
    ``mask[b, h]·grad[b]`` into a dense zero gradient of the table's shape
    (``index_add_``), what JAX's autodiff of the reference's ``jnp.take``
    + masked sum gives.  The JAX
    package has no backward kernel for ``embedding_bag`` (its Pallas kernel
    is forward only), so plain PyTorch is the backward on both devices."""

    @staticmethod
    def forward(ctx, table, idx, mask):
        ctx.save_for_backward(idx, mask)
        ctx.table_shape = table.shape
        if mask.dtype == torch.bool:
            return bag_ops.embedding_bag(table, idx, mask=mask)
        return bag_ops.embedding_bag(table, idx, weights=mask.float())

    @staticmethod
    def backward(ctx, grad):
        idx, mask = ctx.saved_tensors
        V, dim = ctx.table_shape
        ids = idx.long().clamp(0, V - 1).reshape(-1)     # the kernel's clip
        rows = (grad[:, None, :] * mask.to(grad.dtype)[:, :, None])
        g = grad.new_zeros((V, dim))
        g.index_add_(0, ids, rows.reshape(-1, dim))
        return g, None, None


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                  offsets: np.ndarray | None = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Multi-hot bags: idx (..., F, H) with validity ``mask`` -> (..., F, dim).

    gather + masked reduce == torch ``nn.EmbeddingBag`` semantics; "mean"
    divides the sum by max(Σmask, 1)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"unknown combiner {combiner!r}")
    if offsets is not None:
        idx = idx + _offsets_on(offsets, idx.dtype, idx.device)[..., :, None]
    lead, hot = idx.shape[:-1], idx.shape[-1]
    s = _BagSum.apply(table, idx.reshape(-1, hot).to(torch.int32),
                      mask.reshape(-1, hot))
    s = s.reshape(*lead, table.shape[1])
    if combiner == "sum":
        return s
    m = mask.to(s.dtype)[..., None]
    return s / torch.clamp_min(torch.sum(m, dim=-2), 1.0)


def embedding_bag_ragged(table: torch.Tensor, flat_idx: torch.Tensor,
                         segment_ids: torch.Tensor, n_bags: int,
                         weights: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """CSR-style ragged bags: flat_idx (T,), segment_ids (T,) -> (n_bags, dim)
    by gather + ``index_add_`` (the reference's ``segment_sum``)."""
    emb = table[flat_idx.long()]
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    out = table.new_zeros((n_bags, table.shape[1]))
    return out.index_add(0, segment_ids.long(), emb)
