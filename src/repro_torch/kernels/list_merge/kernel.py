"""Binding of ``csrc/list_merge.cu``: rank-and-scatter k-way merge of
sorted inserts into ascending lists, and the arena rotation's merge of its
base rows.

``merge_sorted_cuda`` replaces ``repro/kernels/list_merge/kernel.py::
merge_insert_pallas``.  On an H100 it is bound by device memory (every
list value and id read once and written once); one block per row ranks
each entry by binary search (the row's inserts in shared memory) and
writes it straight to its output slot, instead of the TPU kernel's k + 1
shifted selects.  ``merge_rows_cuda`` does the rotation's gate, stable
partition, head pad, merge and fit of each base row in the same launch,
written straight into the new arena.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import LIST_MERGE, Cost

MAX_INSERTS = 12288          # the row's inserts sit in 48 KB of smem
# The shared memory a block of ``merge_rows_cuda`` can have on an H100.
MAX_ROWS_SMEM = 232_448


def cost(R: int, L: int, k: int) -> Cost:
    """No arithmetic; every list value and id read once and written once
    (16 bytes an entry) and the sorted inserts read once (8 a slot)."""
    return Cost(flops=0.0, bytes=16.0 * R * L + 8.0 * R * k)


def merge_sorted_cuda(vals: torch.Tensor, idx: torch.Tensor,
                      sv: torch.Tensor, si: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """vals (R, L) f32 ascending rows, idx (R, L) int32; sv (R, k) f32
    gated inserts sorted ascending, si (R, k) int32.  Returns merged
    (R, L) (values, ids) (on ``meta`` tensors empty ones, and nothing
    launches)."""
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
        if t.device != vals.device or not (t.is_cuda or t.is_meta) \
                or not t.is_contiguous():
            raise ValueError("merge_sorted_cuda needs contiguous CUDA (or "
                             "meta) tensors on one device")
    out_v = torch.empty_like(vals)
    out_i = torch.empty_like(idx)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(LIST_MERGE.name, cost(R, L, k))
    if R and L and not vals.is_meta:
        LIST_MERGE.launch("merge_insert_f32", vals, idx, sv, si, out_v,
                          out_i, R, L, k)
    return out_v, out_i


def rows_cost(b: int, L: int, k: int, W: int) -> Cost:
    """The rotation's merge of b base rows of width L into width W
    (``merge_rows_cuda``): every old value and id read once and every new
    one written once (8 bytes an entry each way), each row's k inserts
    read once (4 bytes a slot) and the k insert ids once (4 bytes each).
    A row that the partition reorders reads its ids twice more and its
    values once more, and writes again; the bound counts the least."""
    return Cost(flops=0.0, bytes=8.0 * b * (L + W) + 4.0 * b * k + 4.0 * k)


def rows_smem(L: int, k: int) -> int:
    """Shared memory of one ``merge_rows_f32`` block: the row's k inserts
    in burst order, sorted, and their ids, and the row's gated bitmask with
    its scanned counts (``merge_rows_smem`` in the source)."""
    words = (L + 31) // 32
    return 12 * k + 4 * (2 * words + 1)


def merge_rows_cuda(vals: torch.Tensor, idx: torch.Tensor, U: torch.Tensor,
                    ids: torch.Tensor, rows, out_v: torch.Tensor,
                    out_i: torch.Tensor, *, n_base: int,
                    reordered: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch over base rows ``rows`` (a slice, or a list of row ids):
    row r of vals/idx (N, L) f32/int32, gated at ``n_base``, partitioned,
    merged with its k inserts U[:, r] (U (k, >= r + 1) f32, ids (k,)
    int32) and written into row r of out_v/out_i (M, W) f32/int32.  Every
    tensor has unit column stride; rows lie any distance apart, the same
    in idx as in vals and in out_i as in out_v.
    ``reordered`` ((1,) int32, or None) gains 1 for each row the partition
    had to reorder (a gated entry with a value other than SENTINEL).  On
    ``meta`` tensors nothing launches.  Returns (out_v, out_i)."""
    N, L = vals.shape
    k = U.shape[0]
    W = out_v.shape[1]
    if idx.shape != vals.shape or out_i.shape != out_v.shape \
            or ids.shape != (k,):
        raise ValueError(f"shape mismatch: vals {tuple(vals.shape)}, idx "
                         f"{tuple(idx.shape)}, U {tuple(U.shape)}, ids "
                         f"{tuple(ids.shape)}, out {tuple(out_v.shape)} / "
                         f"{tuple(out_i.shape)}")
    if vals.dtype != torch.float32 or U.dtype != torch.float32 \
            or out_v.dtype != torch.float32:
        raise TypeError("vals, U and out_v must be float32")
    if idx.dtype != torch.int32 or ids.dtype != torch.int32 \
            or out_i.dtype != torch.int32:
        raise TypeError("idx, ids and out_i must be int32")
    tensors = [vals, idx, U, ids, out_v, out_i]
    if reordered is not None:
        if reordered.shape != (1,) or reordered.dtype != torch.int32:
            raise TypeError("reordered must be a (1,) int32 tensor")
        tensors.append(reordered)
    for t in tensors:
        if t.device != vals.device or not (t.is_cuda or t.is_meta) \
                or (t.dim() and t.stride(-1) != 1):
            raise ValueError("merge_rows_cuda needs CUDA (or meta) tensors "
                             "on one device with unit column stride")
    if idx.stride(0) != vals.stride(0) or out_i.stride(0) != out_v.stride(0):
        raise ValueError(f"row strides differ: vals {vals.stride(0)}, idx "
                         f"{idx.stride(0)}, out_v {out_v.stride(0)}, out_i "
                         f"{out_i.stride(0)}")
    if rows_smem(L, k) > MAX_ROWS_SMEM:
        raise ValueError(f"rows of {L} with {k} inserts need "
                         f"{rows_smem(L, k)} bytes of shared memory a "
                         f"block, over the card's {MAX_ROWS_SMEM}")
    limit = min(N, out_v.shape[0], U.shape[1])
    if isinstance(rows, slice):
        if rows.step not in (None, 1) or rows.start is None \
                or rows.stop is None or not 0 <= rows.start <= rows.stop \
                <= limit:
            raise ValueError(f"rows {rows}: a unit-step slice within "
                             f"[0, {limit}]")
        row0, n_rows, row_ids = rows.start, rows.stop - rows.start, None
    else:
        row_ids = [int(r) for r in rows]
        if any(r < 0 or r >= limit for r in row_ids):
            raise ValueError(f"row ids must lie in [0, {limit})")
        row0, n_rows = 0, len(row_ids)
        row_ids = torch.tensor(row_ids, dtype=torch.int32,
                               device=vals.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(LIST_MERGE.name, rows_cost(n_rows, L, k, W))
    if n_rows and not vals.is_meta:
        LIST_MERGE.launch("merge_rows_f32", vals, idx, vals.stride(0), U,
                          U.stride(0), ids, row_ids, row0, n_rows, out_v,
                          out_i, out_v.stride(0), L, k, W, int(n_base),
                          reordered)
    return out_v, out_i
