"""Arena health checks (the non-Pallas half of the JAX ``verify_rows``
module; its Pallas kernel is not ported yet)."""
from __future__ import annotations

import torch


def rows_sorted_finite(vals: torch.Tensor, n_active: int) -> torch.Tensor:
    """(R,) per-row flags: live rows must be finite and ascending."""
    R = vals.shape[0]
    live = torch.arange(R, device=vals.device) < n_active
    finite = torch.all(torch.isfinite(vals), dim=1)
    ascending = torch.all(torch.diff(vals, dim=1) >= 0, dim=1)
    return (finite & ascending) | ~live


def arena_healthy(sim_vals: torch.Tensor, ratings: torch.Tensor,
                  norms: torch.Tensor, n_active: int) -> torch.Tensor:
    """() bool — live similarity lists sorted ascending with no non-finite
    values, live rating rows and norms finite, ``n_active`` within
    capacity."""
    R = ratings.shape[0]
    live = torch.arange(R, device=ratings.device) < n_active
    lists_ok = torch.all(rows_sorted_finite(sim_vals, n_active))
    ratings_ok = torch.all(torch.all(torch.isfinite(ratings), dim=1) | ~live)
    norms_ok = torch.all((torch.isfinite(norms) & (norms >= 0)) | ~live)
    n_ok = 0 <= n_active <= R
    return lists_ok & ratings_ok & norms_ok & n_ok
