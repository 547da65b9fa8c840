"""Plain PyTorch version of the kNN scoring kernel.

    score[b, j] = Σ_t w[b,t]·r(nbr[b,t], j) / max(Σ_t w[b,t]·[r≠0], EPS)

with the querying user's rated items at -inf.  The k terms are added in
serial order, one rounded multiply and one rounded add per step, which is
the order the kernel uses; the two therefore agree bit for bit.
"""
from __future__ import annotations

import torch

EPS = 1e-12


def knn_scores_ref(ratings: torch.Tensor, w: torch.Tensor,
                   nbrs: torch.Tensor, users: torch.Tensor) -> torch.Tensor:
    """ratings (N, m); w (B, k) >= 0; nbrs (B, k) and users (B,) in [0, N).
    Returns (B, m) float32 scores, seen items at -inf."""
    B, m = nbrs.shape[0], ratings.shape[1]
    ssum = torch.zeros((B, m), dtype=torch.float32, device=ratings.device)
    dsum = torch.zeros_like(ssum)
    for t in range(nbrs.shape[1]):
        rk = ratings[nbrs[:, t]]
        wk = w[:, t, None]
        ssum = ssum + wk * rk
        dsum = dsum + wk * (rk != 0).float()
    scores = ssum / torch.clamp_min(dsum, EPS)
    return torch.where(ratings[users] != 0, float("-inf"), scores)
