"""Public wrappers of the k-way merge-insert and of the rotation's base
row merge.

``merge_insert`` pre-conditions the inserts outside the kernel — masked
lanes gated to ``NEG_INF`` and each row's inserts stable-sorted ascending,
so ties keep burst order — then launches ``csrc/list_merge.cu`` on CUDA
tensors or runs the same rank-and-scatter in plain PyTorch (``ref.py``) on
CPU tensors (on ``meta`` tensors the kernel's empty outputs, its cost
reported to the active counter).  ``merge_rows`` does the whole of a base
row's rotation merge in one launch on CUDA tensors, and in ``ref.py``'s
plain version on CPU tensors.
The merges do no arithmetic, so kernel and plain version agree bit for
bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.list_merge.kernel import (merge_rows_cuda,
                                                   merge_sorted_cuda)
from repro_torch.kernels.list_merge.ref import (NEG_INF, merge_rows_ref,
                                                merge_sorted_ref)


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


def merge_rows(vals: torch.Tensor, idx: torch.Tensor, U: torch.Tensor,
               ids: torch.Tensor, rows, out_v: torch.Tensor,
               out_i: torch.Tensor, *, n_base: int,
               reordered: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The rotation's merge of base rows ``rows`` (a slice, or a list of
    row ids): row r of the ascending lists vals/idx (N, L), its entries
    with ids at or above ``n_base`` gated out, merged with its k inserts
    U[:, r] (ids ``ids``, (k,) int32) behind k head (SENTINEL, -1) entries,
    and written into row r of out_v/out_i (M, W), head-padded or trimmed
    to W (``ref.merge_rows_ref``).  ``reordered`` ((1,) int32 on the same
    device, or None) gains the rows the partition had to reorder (a gated
    entry with a value other than SENTINEL).
    Writes nothing else of the outputs, and returns them."""
    if vals.is_cuda or vals.is_meta:
        return merge_rows_cuda(vals, idx, U, ids, rows, out_v, out_i,
                               n_base=n_base, reordered=reordered)
    if vals.device.type != "cpu":
        raise ValueError(f"merge_rows: unsupported device {vals.device}")
    if not isinstance(rows, slice):
        rows = torch.as_tensor(list(rows), dtype=torch.long)
    mv, mi, moved = merge_rows_ref(vals[rows], idx[rows], U[:, rows].T, ids,
                                   n_base=n_base, width=out_v.shape[1])
    out_v[rows], out_i[rows] = mv, mi
    if reordered is not None:
        reordered += moved.sum().to(reordered.dtype)
    return out_v, out_i
