"""Plain PyTorch versions of the verification kernel and of the arena
health sweep.

    out[i] = valid[i] AND all_j C[i, j] == r0[j]

compared as values (``-0.0 == 0.0``; NaN equals nothing), as jnp's ``==``.
The sweep's rule is ``live_rows_ok_ref``'s: a live row's list finite and
ascending, its ratings finite, its norm finite and non-negative.
"""
from __future__ import annotations

import torch


def verify_rows_ref(C: torch.Tensor, r0: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """C (s, m) and r0 (m,) of one dtype; valid (s,) bool.  Returns (s,)
    bool."""
    return torch.all(C == r0[None, :], dim=1) & valid


def rows_sorted_finite(vals: torch.Tensor, n_active: int) -> torch.Tensor:
    """(R,) per-row flags: live rows must be finite and ascending."""
    R = vals.shape[0]
    live = torch.arange(R, device=vals.device) < n_active
    finite = torch.all(torch.isfinite(vals), dim=1)
    ascending = torch.all(torch.diff(vals, dim=1) >= 0, dim=1)
    return (finite & ascending) | ~live


def live_rows_ok_ref(sim_vals: torch.Tensor, ratings: torch.Tensor,
                     norms: torch.Tensor, n_live: int,
                     chunk_rows: int) -> torch.Tensor:
    """(n_live,) bool per live row: similarity list finite and ascending,
    ratings finite, norm finite and non-negative.  Swept in slices of
    ``chunk_rows`` rows (the whole Douban-width arena at once would hold
    about 12 GB of temporaries: ``isfinite`` of 7.7 GB of ratings allocates
    their absolute values), with no sync between slices."""
    norms = norms[:n_live]
    ok = torch.isfinite(norms) & (norms >= 0)
    for r0 in range(0, n_live, chunk_rows):
        r1 = min(n_live, r0 + chunk_rows)
        ok[r0:r1] &= rows_sorted_finite(sim_vals[r0:r1], r1 - r0)
        ok[r0:r1] &= torch.all(torch.isfinite(ratings[r0:r1]), dim=1)
    return ok
