"""Binding of ``csrc/verify_rows.cu``: masked row-equality verification of
TwinSearch candidates.

Replaces ``repro/kernels/verify_rows/kernel.py::verify_rows_pallas``.  On
an H100 it is bound by device memory (one pass over the (s, m) candidate
block); one block per row reads it as a scalar head, a body of aligned
16-byte loads (r0's matching bytes shifted into place) and a scalar tail,
and AND-reduces with ``__syncthreads_and``.  Instantiated for float32 and
int8.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import VERIFY_ROWS

ENTRY = {torch.float32: "verify_rows_f32", torch.int8: "verify_rows_i8"}


def verify_rows_cuda(C: torch.Tensor, r0: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """C (s, m) and r0 (m,) of one dtype in ``ENTRY``; valid (s,) bool.
    Returns (s,) bool."""
    s, m = C.shape
    if r0.shape != (m,) or valid.shape != (s,):
        raise ValueError(f"shape mismatch: C {tuple(C.shape)}, r0 "
                         f"{tuple(r0.shape)}, valid {tuple(valid.shape)}")
    if C.dtype != r0.dtype or C.dtype not in ENTRY:
        raise TypeError(f"C and r0 must share dtype float32 or int8, got "
                        f"{C.dtype} and {r0.dtype}")
    if valid.dtype != torch.bool:
        raise TypeError("valid must be bool")
    for t in (C, r0, valid):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("verify_rows_cuda needs contiguous CUDA "
                             "tensors")
    out = torch.empty((s,), dtype=torch.bool, device=C.device)
    if s:
        VERIFY_ROWS.launch(ENTRY[C.dtype], C, r0, valid, out, s, m)
    return out
