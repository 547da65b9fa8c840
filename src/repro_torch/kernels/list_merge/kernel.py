"""Binding of ``csrc/list_merge.cu``: rank-and-scatter k-way merge of
sorted inserts into ascending lists.

Replaces ``repro/kernels/list_merge/kernel.py::merge_insert_pallas``.  On
an H100 it is bound by device memory (every list value and id read once
and written once); one block per row ranks each entry by binary search
(the row's inserts in shared memory) and writes it straight to its output
slot, instead of the TPU kernel's k + 1 shifted selects.  Details in the
source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import LIST_MERGE

MAX_INSERTS = 12288          # the row's inserts sit in 48 KB of smem


def merge_sorted_cuda(vals: torch.Tensor, idx: torch.Tensor,
                      sv: torch.Tensor, si: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """vals (R, L) f32 ascending rows, idx (R, L) int32; sv (R, k) f32
    gated inserts sorted ascending, si (R, k) int32.  Returns merged
    (R, L) (values, ids)."""
    R, L = vals.shape
    k = sv.shape[1]
    if idx.shape != (R, L) or sv.shape != (R, k) or si.shape != (R, k):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)}, sv {tuple(sv.shape)}, si "
                         f"{tuple(si.shape)}")
    if vals.dtype != torch.float32 or sv.dtype != torch.float32:
        raise TypeError("vals and inserts must be float32")
    if idx.dtype != torch.int32 or si.dtype != torch.int32:
        raise TypeError("ids must be int32")
    if k > MAX_INSERTS:
        raise ValueError(f"{k} inserts per row exceed {MAX_INSERTS}")
    for t in (vals, idx, sv, si):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("merge_sorted_cuda needs contiguous CUDA "
                             "tensors")
    out_v = torch.empty_like(vals)
    out_i = torch.empty_like(idx)
    if R and L:
        LIST_MERGE.launch("merge_insert_f32", vals, idx, sv, si, out_v,
                          out_i, R, L, k)
    return out_v, out_i
