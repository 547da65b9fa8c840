"""Public wrapper of the similarity kernel.

On CUDA tensors it launches ``csrc/similarity.cu``; on CPU tensors it runs
the plain version in ``ref.py``; on ``meta`` tensors it returns the
kernel's empty output and reports its cost to the active counter.  The kernel masks ragged edges itself, so
nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.similarity.kernel import similarity_cuda
from repro_torch.kernels.similarity.ref import EPS, similarity_ref


def cosine_similarity(Q: torch.Tensor, R: torch.Tensor,
                      q_norms: torch.Tensor | None = None,
                      r_norms: torch.Tensor | None = None) -> torch.Tensor:
    """Cosine similarity of each row of Q against each row of R — the
    traditional-path hot loop, on the hand-written kernel."""
    if q_norms is None:
        q_norms = torch.sqrt(torch.sum(torch.square(Q.float()), dim=1))
    if r_norms is None:
        r_norms = torch.sqrt(torch.sum(torch.square(R.float()), dim=1))
    qn = torch.clamp_min(q_norms.float(), EPS)
    rn = torch.clamp_min(r_norms.float(), EPS)
    if Q.is_cuda or Q.is_meta:
        return similarity_cuda(Q.contiguous(), R.contiguous(),
                               qn.contiguous(), rn.contiguous())
    if Q.device.type == "cpu":
        return similarity_ref(Q, R, qn, rn)
    raise ValueError(f"cosine_similarity: unsupported device {Q.device}")
