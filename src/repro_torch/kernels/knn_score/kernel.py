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

from repro_torch.kernels._lib import KNN_SCORE

MAX_BATCH = 65535            # rows ride on gridDim.y


def knn_scores_cuda(ratings: torch.Tensor, w: torch.Tensor,
                    nbrs: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
    """ratings (N, m) f32; w (B, k) f32; nbrs (B, k) and users (B,) int32 in
    [0, N).  Returns (B, m) f32."""
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
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("knn_scores_cuda needs contiguous CUDA tensors")
    out = torch.empty((B, m), dtype=torch.float32, device=ratings.device)
    if B and m:
        KNN_SCORE.launch("knn_scores_f32", ratings, w, nbrs, users, out,
                         B, k, m)
    return out
