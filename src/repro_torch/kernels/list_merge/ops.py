"""Public wrapper of the k-way merge-insert.

Pre-conditions the inserts outside the kernel — masked lanes gated to
``NEG_INF`` and each row's inserts stable-sorted ascending, so ties keep
burst order — then launches ``csrc/list_merge.cu`` on CUDA tensors or runs
the same rank-and-scatter in plain PyTorch (``ref.py``) on CPU tensors
(on ``meta`` tensors the kernel's empty outputs, its cost reported to the
active counter).
The merge does no arithmetic, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.list_merge.kernel import merge_sorted_cuda
from repro_torch.kernels.list_merge.ref import NEG_INF, merge_sorted_ref


def _sort_inserts(ins_vals: torch.Tensor, ins_idx: torch.Tensor,
                  ins_mask: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    gated = torch.where(ins_mask, ins_vals, NEG_INF)
    sv, order = torch.sort(gated, dim=1, stable=True)
    return sv, torch.gather(ins_idx, 1, order)


def merge_insert(vals: torch.Tensor, idx: torch.Tensor,
                 ins_vals: torch.Tensor, ins_idx: torch.Tensor,
                 ins_mask: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Merge k (value, id) inserts into each of R ascending lists.

    Args:
      vals:     (R, L) float32 ascending per row, values in
                (NEG_INF, POS_INF).
      idx:      (R, L) int32 companion ids.
      ins_vals: (R, k) insert values in burst order.
      ins_idx:  (k,) or (R, k) int32 insert ids.
      ins_mask: optional (R, k) bool; False lanes are exact no-ops.

    Returns (vals', idx') of shape (R, L): the merged lists with the k
    smallest merged elements dropped.
    """
    R, L = vals.shape
    k = ins_vals.shape[-1]
    vals = vals.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    ins_vals = ins_vals.float().expand(R, k)
    ins_idx = ins_idx.to(torch.int32).expand(R, k)
    if ins_mask is None:
        ins_mask = torch.ones((R, k), dtype=torch.bool, device=vals.device)
    else:
        ins_mask = ins_mask.expand(R, k)
    sv, si = _sort_inserts(ins_vals, ins_idx, ins_mask)
    if vals.is_cuda or vals.is_meta:
        return merge_sorted_cuda(vals, idx, sv.contiguous(), si.contiguous())
    if vals.device.type == "cpu":
        return merge_sorted_ref(vals, idx, sv, si)
    raise ValueError(f"merge_insert: unsupported device {vals.device}")
