"""Public wrapper of the similarity kernel.

On CUDA tensors it launches ``csrc/similarity.cu``; on CPU tensors it runs
the plain version in ``ref.py``; on ``meta`` tensors it returns the
kernel's empty output and reports its cost to the active counter.  The
kernel masks ragged edges itself, so nothing is padded to a tile.  The bf16
route reads rows by TMA, which needs 16-byte-aligned rows: a bf16 input
whose rows are not is copied into a buffer of row stride roundup(m, 8)
first (``kernel.row_buffer``), as the reference's wrapper pads to its
blocks.  Callers that own their rows, as ``models/cf.build_step`` does,
write them aligned and pay no copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.similarity.kernel import (row_buffer, rows_aligned,
                                                   similarity_cuda)
from repro_torch.kernels.similarity.ref import EPS, similarity_ref


def _kernel_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the kernel takes it: bf16 rows aligned (copied if they are
    not), any other dtype contiguous."""
    if x.dtype != torch.bfloat16:
        return x.contiguous()
    if rows_aligned(x):
        return x
    return row_buffer(*x.shape, x.dtype, x.device).copy_(x)


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
        return similarity_cuda(_kernel_rows(Q), _kernel_rows(R),
                               qn.contiguous(), rn.contiguous())
    if Q.device.type == "cpu":
        return similarity_ref(Q, R, qn, rn)
    raise ValueError(f"cosine_similarity: unsupported device {Q.device}")
