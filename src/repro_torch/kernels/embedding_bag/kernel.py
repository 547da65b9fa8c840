"""Binding of ``csrc/embedding_bag.cu``: the sum-combiner EmbeddingBag.

Replaces ``repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``.
On an H100 it is bound by device memory (each distinct table row read
once, plus the indices, weights and output); one thread per (bag, column)
adds the bag's terms in serial order without FMA contraction, so it
matches the plain version bit for bit.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import EMBEDDING_BAG

THREADS = 256
MAX_BLOCKS = 2**31 - 1       # gridDim.x


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """table (V, dim) f32; idx (n_bags, hot) int32 in [0, V); w (n_bags,
    hot) f32.  Returns (n_bags, dim) f32."""
    V, dim = table.shape
    n_bags, hot = idx.shape
    if w.shape != (n_bags, hot):
        raise ValueError(f"shape mismatch: idx {tuple(idx.shape)}, w "
                         f"{tuple(w.shape)}")
    if table.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("table and w must be float32")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if -(-n_bags * dim // THREADS) > MAX_BLOCKS:
        raise ValueError(f"{n_bags} bags x {dim} columns exceed one grid")
    for t in (table, idx, w):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("embedding_bag_cuda needs contiguous CUDA "
                             "tensors")
    out = torch.empty((n_bags, dim), dtype=torch.float32,
                      device=table.device)
    if n_bags and dim:
        EMBEDDING_BAG.launch("embedding_bag_f32", table, idx, w, out,
                             n_bags, hot, dim)
    return out
