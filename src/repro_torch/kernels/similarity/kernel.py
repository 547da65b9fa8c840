"""Binding of ``csrc/similarity.cu``: the cosine-similarity product with
the norm epilogue fused in.

Replaces ``repro/kernels/similarity/kernel.py::similarity_pallas``.  One
route per operand type:

* **bf16** (``cosine_similarity_bf16_wgmma``): the tensor cores.  On an
  H100 it is bound by 2·nq·n·m operations at the bf16 rate (989 TFLOP/s)
  for a large nq (``models/cf.build_step``) and by the single read of R
  for a small one.  A bf16 product is exact in fp32 and ``wgmma`` sums in
  fp32, so only the order of the sums differs from the plain version.
  Design: 128 x 256 block tiles (rows of Q x rows of R), a 4-stage ring of
  64-item slices that one producer thread fills by TMA (128-byte swizzle,
  zeros past the edges) behind full and empty ``mbarrier``s, and two
  consumer warpgroups of ``wgmma.m64n128k16`` with fp32 accumulators in
  registers.  TMA needs 16-byte-aligned rows: the wrapper takes rows of
  unit item stride, a row stride that is a multiple of 8 items and a
  16-byte-aligned base, and passes the strides; anything else raises.
* **f32** (``cosine_similarity_f32_bm32`` / ``_bm64``): the CUDA cores.
  Bound by fp32 operations at nq = 64 (2·nq·n·m at 67 TFLOP/s; no TF32,
  whose three digits would break the 1e-6 twin tolerance) and by the
  single read of the ratings arena at the server's burst of 32.  A
  pipelined SGEMM: 128-column block tiles of 64 or 32 rows of Q, 8 x 16
  register tiles in groups that split each slice's depth, and a 4-stage
  ``cp.async`` ring of the 16-byte-aligned chunks that cover each row's
  slice (rows are only 4-byte aligned).  Contiguous inputs.

Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import SIMILARITY, Cost

BF16_ENTRY = "cosine_similarity_bf16_wgmma"
# The bf16 route's row alignment, in items: TMA reads rows whose base and
# stride are multiples of 16 bytes.
BF16_ALIGN = 8


def block_rows(nq: int) -> int:
    """Rows of Q per block tile of the f32 route: 32 up to the server's
    burst of 32 (a 64-row tile would spend half its FMAs on zero rows
    there), else 64."""
    return 32 if nq <= 32 else 64


def entry_point(dtype: torch.dtype, nq: int) -> str:
    """The C entry point for ``dtype`` inputs and ``nq`` rows of Q."""
    if dtype == torch.bfloat16:
        return BF16_ENTRY
    return f"cosine_similarity_f32_bm{block_rows(nq)}"


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether the bf16 route can read ``x``'s rows as they lie: unit item
    stride, a row stride of a multiple of ``BF16_ALIGN`` items and a
    16-byte-aligned base (an empty matrix always)."""
    if x.numel() == 0:
        return True
    return (x.stride(1) == 1 and x.stride(0) % BF16_ALIGN == 0
            and x.data_ptr() % 16 == 0)


def row_buffer(n: int, m: int, dtype: torch.dtype,
               device: torch.device | str) -> torch.Tensor:
    """An empty (n, m) matrix whose rows the kernel takes as they lie: for
    bf16 the ``[:, :m]`` view of an (n, roundup(m, 8)) buffer whose pad
    columns are zero, so the whole buffer holds the same row products;
    else a contiguous one."""
    if dtype != torch.bfloat16:
        return torch.empty((n, m), dtype=dtype, device=device)
    ld = -(-m // BF16_ALIGN) * BF16_ALIGN
    buf = torch.empty((n, ld), dtype=dtype, device=device)
    buf[:, m:].zero_()
    return buf[:, :m]


def cost(nq: int, n: int, m: int, dtype: torch.dtype) -> Cost:
    """2·nq·n·m operations (fp32 on the CUDA cores, bf16 on the tensor
    cores); Q and R read once in their dtype, both norms read and the
    (nq, n) f32 block written once."""
    return Cost(flops=2.0 * nq * n * m,
                bytes=dtype.itemsize * (nq * m + n * m) + 4.0 * (nq * n + nq + n),
                fp32=dtype == torch.float32)


def launch_similarity(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                      r_norms: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the entry point for ``Q``'s dtype and rows, writing ``out``;
    inputs already checked by ``similarity_cuda``.  The bf16 entry point
    also takes the row strides of Q and R."""
    nq, m = Q.shape
    n = R.shape[0]
    if not (nq and n):
        return
    strides = (Q.stride(0), R.stride(0)) if Q.dtype == torch.bfloat16 else ()
    SIMILARITY.launch(entry_point(Q.dtype, nq), Q, R, q_norms, r_norms, out,
                      nq, n, m, *strides)


def similarity_cuda(Q: torch.Tensor, R: torch.Tensor, q_norms: torch.Tensor,
                    r_norms: torch.Tensor) -> torch.Tensor:
    """Q (nq, m) and R (n, m) of one dtype (f32 or bf16); q_norms (nq,) and
    r_norms (n,) f32, already clamped to >= EPS.  f32 matrices are
    contiguous; bf16 ones have ``rows_aligned`` rows.  Returns (nq, n) f32
    (on ``meta`` tensors an empty one, and nothing launches)."""
    nq, m = Q.shape
    n, m2 = R.shape
    if m != m2 or q_norms.shape != (nq,) or r_norms.shape != (n,):
        raise ValueError(f"shape mismatch: Q {tuple(Q.shape)}, R "
                         f"{tuple(R.shape)}, q_norms "
                         f"{tuple(q_norms.shape)}, r_norms "
                         f"{tuple(r_norms.shape)}")
    if Q.dtype != R.dtype or Q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"Q and R must share dtype float32 or bfloat16, got "
                        f"{Q.dtype} and {R.dtype}")
    if q_norms.dtype != torch.float32 or r_norms.dtype != torch.float32:
        raise TypeError("norms must be float32")
    for t in (Q, R, q_norms, r_norms):
        if t.device != Q.device or not (t.is_cuda or t.is_meta):
            raise ValueError("similarity_cuda needs CUDA (or meta) tensors "
                             "on one device")
    mats = (Q, R) if Q.dtype == torch.float32 else ()
    if not all(t.is_contiguous() for t in (*mats, q_norms, r_norms)):
        raise ValueError("similarity_cuda needs contiguous f32 matrices and "
                         "norms")
    if Q.dtype == torch.bfloat16:
        for name, t in (("Q", Q), ("R", R)):
            if not rows_aligned(t):
                raise ValueError(
                    f"similarity_cuda: bf16 {name} needs unit item stride, "
                    f"a row stride of a multiple of {BF16_ALIGN} items and a "
                    f"16-byte-aligned base (TMA), got strides "
                    f"{tuple(t.stride())} at address {t.data_ptr()}")
    out = torch.empty((nq, n), dtype=torch.float32, device=Q.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(SIMILARITY.name, cost(nq, n, m, Q.dtype))
    if not Q.is_meta:
        launch_similarity(Q, R, q_norms, r_norms, out)
    return out
