"""Public wrappers of the kNN scoring kernel.

``knn_scores`` launches ``csrc/knn_score.cu`` on CUDA tensors and runs the
serial plain version (``ref.py``) on CPU tensors; both add the k terms in
the same order and agree bit for bit.  ``knn_recommend_topn`` adds the
top-n cut, outside the kernel, with ``lax.top_k``'s lower-index-first tie
rule (unrated items all score 0, so ties are the rule, not the exception).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.knn_score.kernel import knn_scores_cuda
from repro_torch.kernels.knn_score.ref import knn_scores_ref
from repro_torch.sorting import top_k


def knn_scores(ratings: torch.Tensor, w: torch.Tensor, nbrs: torch.Tensor,
               users: torch.Tensor) -> torch.Tensor:
    """Batched kNN item scores from precomputed neighbour lists.

    Args:
      ratings: (N, m) arena rating matrix (0 = unrated).
      w:       (B, k) non-negative neighbour weights (``max(sims, 0)``;
               zero-weight slots are exact no-ops).
      nbrs:    (B, k) neighbour row ids (clipped to [0, N)).
      users:   (B,) querying users (clipped; their rated items mask to -inf).

    Returns (B, m) float32 scores, seen items at -inf.
    """
    N = ratings.shape[0]
    ratings = ratings.float()
    w = w.float()
    nbrs = torch.clamp(nbrs, 0, N - 1).to(torch.int32)
    users = torch.clamp(users, 0, N - 1).to(torch.int32)
    if ratings.is_cuda:
        return knn_scores_cuda(ratings.contiguous(), w.contiguous(),
                               nbrs.contiguous(), users.contiguous())
    if ratings.device.type == "cpu":
        return knn_scores_ref(ratings, w, nbrs.long(), users.long())
    raise ValueError(f"knn_scores: unsupported device {ratings.device}")


def knn_recommend_topn(ratings: torch.Tensor, w: torch.Tensor,
                       nbrs: torch.Tensor, users: torch.Tensor,
                       n_rec: int = 10) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores + top-``n_rec`` unseen items.  Returns ((B, n_rec) scores,
    (B, n_rec) int64 item ids)."""
    return top_k(knn_scores(ratings, w, nbrs, users), n_rec)
