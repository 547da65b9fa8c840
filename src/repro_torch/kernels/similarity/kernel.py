"""Binding of ``csrc/similarity.cu``: the cosine-similarity product with
the norm epilogue fused in.

Replaces ``repro/kernels/similarity/kernel.py::similarity_pallas``.  On an
H100 it is bound by fp32 operations on the CUDA cores at nq = 64
(2·nq·n·m at 67 TFLOP/s; no TF32, whose three digits would break the 1e-6
twin tolerance) and by the single read of the ratings arena at the
server's burst of 32.  The kernel is a pipelined SGEMM: 128-column block
tiles of 64 or 32 rows of Q, 8 x 16 register tiles in groups that split
each slice's depth, and a 4-stage ``cp.async`` ring of the 16-byte-aligned
chunks that cover each row's slice (rows are only 4-byte aligned).
Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import SIMILARITY, Cost

_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16"}


def block_rows(nq: int) -> int:
    """Rows of Q per block tile: 32 up to the server's burst of 32 (a
    64-row tile would spend half its FMAs on zero rows there), else 64."""
    return 32 if nq <= 32 else 64


def entry_point(dtype: torch.dtype, nq: int) -> str:
    """The C entry point for ``dtype`` inputs and ``nq`` rows of Q."""
    return f"cosine_similarity_{_DTYPE[dtype]}_bm{block_rows(nq)}"


def cost(nq: int, n: int, m: int, dtype: torch.dtype) -> Cost:
    """2·nq·n·m operations (fp32 on the CUDA cores, bf16 on the tensor
    cores); Q and R read once in their dtype, both norms read and the
    (nq, n) f32 block written once."""
    return Cost(flops=2.0 * nq * n * m,
                bytes=dtype.itemsize * (nq * m + n * m) + 4.0 * (nq * n + nq + n),
                fp32=dtype == torch.float32)


def launch_similarity(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                      r_norms: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the variant that ``block_rows`` picks for ``Q``'s rows,
    writing ``out``; inputs already checked by ``similarity_cuda``."""
    nq, m = Q.shape
    n = R.shape[0]
    if nq and n:
        SIMILARITY.launch(entry_point(Q.dtype, nq), Q, R, q_norms, r_norms,
                          out, nq, n, m)


def similarity_cuda(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                    r_norms: torch.Tensor) -> torch.Tensor:
    """Q (nq, m) and R (n, m) of one dtype (f32 or bf16); q_norms (nq,) and
    r_norms (n,) f32, already clamped to >= EPS.  Returns (nq, n) f32 (on
    ``meta`` tensors an empty one, and nothing launches)."""
    nq, m = Q.shape
    n, m2 = R.shape
    if m != m2 or q_norms.shape != (nq,) or r_norms.shape != (n,):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, R "
                         f"{tuple(R.shape)}, q_norms "
                         f"{tuple(q_norms.shape)}, r_norms "
                         f"{tuple(r_norms.shape)}")
    if Q.dtype != R.dtype or Q.dtype not in _DTYPE:
        raise TypeError(f"Q and R must share dtype float32 or bfloat16, got "
                        f"{Q.dtype} and {R.dtype}")
    if q_norms.dtype != torch.float32 or r_norms.dtype != torch.float32:
        raise TypeError("norms must be float32")
    for t in (Q, R, q_norms, r_norms):
        if t.device != Q.device or not (t.is_cuda or t.is_meta) \
                or not t.is_contiguous():
            raise ValueError("similarity_cuda needs contiguous CUDA (or "
                             "meta) tensors on one device")
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(SIMILARITY.name, cost(nq, n, m, Q.dtype))
    if not Q.is_meta:
        launch_similarity(Q, R, q_norms, r_norms, out)
    return out
