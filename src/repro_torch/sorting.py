"""Sorts with the tie rules the JAX reference relies on.

``jnp.argsort`` is stable, and ``lax.top_k`` puts the lower index first
among equal values.  ``torch.sort`` is stable only when asked, and
``torch.topk`` promises no tie order on CUDA, so every sort in the port goes
through these two helpers.  Ties are common: SENTINEL fills every partial
list, unrated items all score 0, and twins tie in similarity.
"""
from __future__ import annotations

import torch


def argsort_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort along the last axis: (values, int64 order)."""
    return torch.sort(x, dim=-1, stable=True)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, in descending order,
    lower index first among equal values.  Returns (values, int64 index)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
