"""Binding of ``csrc/similarity.cu``: the cosine-similarity product with
the norm epilogue fused in.

Replaces ``repro/kernels/similarity/kernel.py::similarity_pallas``.  On an
H100 it is bound by fp32 operations on the CUDA cores (2·nq·n·m at
67 TFLOP/s; no TF32, whose three digits would break the 1e-6 twin
tolerance), with the single read of the ratings arena close behind; the
kernel is a shared-memory tiled SGEMM (64 x 64 tiles, 4 x 4 per thread)
that streams the arena once per column tile.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import SIMILARITY

_ENTRY = {torch.float32: "cosine_similarity_f32",
          torch.bfloat16: "cosine_similarity_bf16"}


def similarity_cuda(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                    r_norms: torch.Tensor) -> torch.Tensor:
    """Q (nq, m) and R (n, m) of one dtype (f32 or bf16); q_norms (nq,) and
    r_norms (n,) f32, already clamped to >= EPS.  Returns (nq, n) f32."""
    nq, m = Q.shape
    n, m2 = R.shape
    if m != m2 or q_norms.shape != (nq,) or r_norms.shape != (n,):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, R "
                         f"{tuple(R.shape)}, q_norms "
                         f"{tuple(q_norms.shape)}, r_norms "
                         f"{tuple(r_norms.shape)}")
    if Q.dtype != R.dtype or Q.dtype not in _ENTRY:
        raise TypeError(f"Q and R must share dtype float32 or bfloat16, got "
                        f"{Q.dtype} and {R.dtype}")
    if q_norms.dtype != torch.float32 or r_norms.dtype != torch.float32:
        raise TypeError("norms must be float32")
    for t in (Q, R, q_norms, r_norms):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("similarity_cuda needs contiguous CUDA tensors")
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    if nq and n:
        SIMILARITY.launch(_ENTRY[Q.dtype], Q, R, q_norms, r_norms, out,
                          nq, n, m)
    return out
