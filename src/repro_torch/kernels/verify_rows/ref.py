"""Plain PyTorch version of the verification kernel.

    out[i] = valid[i] AND all_j C[i, j] == r0[j]

compared as values (``-0.0 == 0.0``; NaN equals nothing), as jnp's ``==``.
"""
from __future__ import annotations

import torch


def verify_rows_ref(C: torch.Tensor, r0: torch.Tensor, valid: torch.Tensor
                    ) -> torch.Tensor:
    """C (s, m) and r0 (m,) of one dtype; valid (s,) bool.  Returns (s,)
    bool."""
    return torch.all(C == r0[None, :], dim=1) & valid
