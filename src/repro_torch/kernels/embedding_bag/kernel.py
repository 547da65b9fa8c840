"""Binding of ``csrc/embedding_bag.cu``: the sum-combiner EmbeddingBag.

Replaces ``repro/kernels/embedding_bag/kernel.py::embedding_bag_pallas``
and its wrapper's elementwise steps.  On an H100 its bound is device
memory (each distinct table row read once, plus the indices, weights, mask
and output), and in practice the per-slot row gathers; each thread loads
its bag's ids and weights first, then all its rows, then adds them in
serial order without FMA contraction, so it matches the plain version bit
for bit.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import EMBEDDING_BAG, Cost

THREADS = 128
MAX_BLOCKS = 2**31 - 1       # gridDim.x
# Thread layouts: one thread per (bag, column), or per (bag, column pair).
COLUMN, PAIR = "column", "pair"
# The layout timed faster at xDeepFM's serve_bulk shape (chip_smoke.py
# phase 5 times both in turns; PERF.md §6); the other stays selectable for
# that comparison, and serves an odd dim.
LAYOUT = PAIR


def cost(V: int, n_bags: int, hot: int, dim: int, *, weighted: bool,
         masked: bool, rows: int | None = None) -> Cost:
    """An add a slot and column, and a multiply for each of the weights and
    the mask; ``rows`` distinct table rows read once (without it, the most
    the shapes allow, min(V, n_bags·hot): the distinct count is data, and a
    trace does not read data), the int32 ids, f32 weights and bool mask
    read and the (n_bags, dim) f32 output written once."""
    if rows is None:
        rows = min(V, n_bags * hot)
    slots = n_bags * hot
    return Cost(flops=(1.0 + weighted + masked) * slots * dim,
                bytes=(4.0 * rows * dim + (4.0 + 4 * weighted + masked) * slots
                       + 4.0 * n_bags * dim))


def embedding_bag_cuda(table: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor | None = None,
                       mask: torch.Tensor | None = None, *,
                       layout: str = LAYOUT) -> torch.Tensor:
    """table (V, dim) f32; idx (n_bags, hot) int32, clipped to [0, V) by
    the kernel; w (n_bags, hot) f32 or None (weights of 1); mask (n_bags,
    hot) bool or None, multiplied into the weights.  ``layout`` PAIR falls
    back to COLUMN where dim is odd or the table is not 8-byte aligned.
    Returns (n_bags, dim) f32 (on ``meta`` tensors an empty one, and
    nothing launches)."""
    V, dim = table.shape
    n_bags, hot = idx.shape
    for name, t, dt in (("w", w, torch.float32), ("mask", mask, torch.bool)):
        if t is None:
            continue
        if t.shape != (n_bags, hot):
            raise ValueError(f"shape mismatch: idx {tuple(idx.shape)}, "
                             f"{name} {tuple(t.shape)}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, not {t.dtype}")
    if table.dtype != torch.float32:
        raise TypeError("table must be float32")
    if idx.dtype != torch.int32:
        raise TypeError("idx must be int32")
    if layout not in (COLUMN, PAIR):
        raise ValueError(f"unknown layout {layout!r}")
    pairs = (layout == PAIR and dim % 2 == 0
             and table.data_ptr() % 8 == 0)
    if -(-n_bags * (dim // 2 if pairs else dim) // THREADS) > MAX_BLOCKS:
        raise ValueError(f"{n_bags} bags x {dim} columns exceed one grid")
    for t in (table, idx, w, mask):
        if t is not None and (t.device != table.device
                              or not (t.is_cuda or t.is_meta)
                              or not t.is_contiguous()):
            raise ValueError("embedding_bag_cuda needs contiguous CUDA (or "
                             "meta) tensors on one device")
    out = torch.empty((n_bags, dim), dtype=torch.float32,
                      device=table.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(EMBEDDING_BAG.name, cost(
            V, n_bags, hot, dim, weighted=w is not None,
            masked=mask is not None))
    if n_bags and dim and not table.is_meta:
        if V == 0 and hot:
            raise ValueError("embedding_bag: empty table")
        vec = int(hot % 4 == 0 and idx.data_ptr() % 16 == 0
                  and (w is None or w.data_ptr() % 16 == 0)
                  and (mask is None or mask.data_ptr() % 4 == 0))
        EMBEDDING_BAG.launch("embedding_bag_f32", table, idx, w, mask, out,
                             V, n_bags, hot, dim, vec, int(pairs))
    return out
