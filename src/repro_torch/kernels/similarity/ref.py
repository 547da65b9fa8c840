"""Plain PyTorch version of the similarity kernel."""
from __future__ import annotations

import torch

EPS = 1e-12


def similarity_ref(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                   r_norms: torch.Tensor) -> torch.Tensor:
    """(nq, m), (n, m) -> (nq, n): Q·Rᵀ in fp32 over max(qn·rn, EPS)."""
    dots = Q.float() @ R.float().T
    denom = torch.clamp_min(q_norms[:, None] * r_norms[None, :], EPS)
    return dots / denom
