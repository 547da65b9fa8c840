"""Plain PyTorch version of the twin-probe intersection kernel.

    mask[x] = all_i |rows[i, x] − s0_i| <= tol,    count = Σ_x mask[x]

in the inputs' dtype (float32 on the serving path), as jnp computes it.
The count covers real columns only (the JAX wrapper's count also covers
its -3.0 padding, which can match when tol >= 2; see ROADMAP Queue 3).
"""
from __future__ import annotations

import torch


def twin_probe_ref(rows: torch.Tensor, sims0: torch.Tensor, tol: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows (c, N); sims0 (c,).  Returns (mask (N,) bool, count 0-d
    int32)."""
    hit = torch.abs(rows - sims0[:, None]) <= tol
    mask = torch.all(hit, dim=0)
    return mask, torch.sum(mask, dtype=torch.int32)
