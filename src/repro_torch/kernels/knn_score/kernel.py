"""Binding of ``csrc/knn_score.cu``: batched kNN item scoring that gathers
neighbour rows by index.

Replaces ``repro/kernels/knn_score/kernel.py::knn_scores_pallas``.  On an
H100 it is bound by device memory (each distinct neighbour row read once,
the (B, m) scores written once); one block per (item tile, query row)
walks the k neighbours in order with coalesced row loads, so the (B, k, m)
gather never exists, and adds in serial order without FMA contraction so
it matches the plain version bit for bit.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import KNN_SCORE, Cost

MAX_BATCH = 65535            # rows ride on gridDim.y


def cost(N: int, m: int, B: int, k: int, rows: int | None = None) -> Cost:
    """4·B·k·m + B·m operations; ``rows`` distinct rating rows read once
    (the neighbours' and the users'; without it, the most the shapes
    allow, min(N, B·(k + 1)): the distinct count is data, and a trace does
    not read data), the weights, ids and users read and the (B, m) scores
    written once."""
    if rows is None:
        rows = min(N, B * (k + 1))
    return Cost(flops=4.0 * B * k * m + B * m,
                bytes=4.0 * rows * m + 8.0 * B * k + 4.0 * B + 4.0 * B * m)


def knn_scores_cuda(ratings: torch.Tensor, w: torch.Tensor,
                    nbrs: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
    """ratings (N, m) f32; w (B, k) f32; nbrs (B, k) and users (B,) int32 in
    [0, N).  Returns (B, m) f32 (on ``meta`` tensors an empty one, and
    nothing launches)."""
    N, m = ratings.shape
    B, k = w.shape
    if nbrs.shape != (B, k) or users.shape != (B,):
        raise ValueError(f"shape mismatch: w {tuple(w.shape)}, nbrs "
                         f"{tuple(nbrs.shape)}, users {tuple(users.shape)}")
    if ratings.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError("ratings and w must be float32")
    if nbrs.dtype != torch.int32 or users.dtype != torch.int32:
        raise TypeError("nbrs and users must be int32")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds {MAX_BATCH}")
    for t in (ratings, w, nbrs, users):
        if t.device != ratings.device or not (t.is_cuda or t.is_meta) \
                or not t.is_contiguous():
            raise ValueError("knn_scores_cuda needs contiguous CUDA (or "
                             "meta) tensors on one device")
    out = torch.empty((B, m), dtype=torch.float32, device=ratings.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(KNN_SCORE.name, cost(N, m, B, k))
    if B and m and not ratings.is_meta:
        KNN_SCORE.launch("knn_scores_f32", ratings, w, nbrs, users, out,
                         B, k, m)
    return out
