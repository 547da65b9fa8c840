"""Plain PyTorch versions of the k-way merge-insert.

Semantics (shared by every backend): each row holds an ascending list of
width L; a burst of k (value, id) inserts is merged in *burst order* and
the k smallest elements of the merged (L + k) multiset are dropped.  Ties
order as (value, age): row entries are older than every insert, inserts
age by burst position — exactly k sequential ``searchsorted(side="right")``
drop-min inserts.  Masked-off inserts take the value ``NEG_INF`` (below
SENTINEL), sort to the front and are always dropped.  ``fit_width`` is the
list format's one head pad or trim, which the rotation uses too.
"""
from __future__ import annotations

import torch

# ``repro_torch.core.types.SENTINEL``: an empty list slot.
SENTINEL = -2.0
# Strictly below SENTINEL: a masked insert is always dropped.
NEG_INF = -3.0
# Strictly above any list value: column padding of the TPU kernel's layout.
POS_INF = 4.0


def merge_sorted_ref(vals: torch.Tensor, idx: torch.Tensor,
                     sv: torch.Tensor, si: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, by rank and scatter: (R, L) ascending rows
    and (R, k) gated inserts sorted ascending -> merged (R, L).

    Row entry j lands at merged rank j + #{inserts < row[j]}; insert t at
    #{row <= s_t} + t.  The ranks are a permutation of 0..L+k-1; ranks below
    k are dropped (scattered to a spare column L and sliced away)."""
    R, L = vals.shape
    k = sv.shape[1]
    dev = vals.device
    # In place where it can be: at a 32k x 32k arena each (R, L) int64
    # temporary is 8.6 GB.
    t_row = torch.searchsorted(sv, vals, side="left")
    t_row += torch.arange(-k, L - k, device=dev)[None, :]
    t_row[t_row < 0] = L
    t_ins = torch.searchsorted(vals, sv, side="right")
    t_ins += torch.arange(-k, 0, device=dev)[None, :]
    t_ins[t_ins < 0] = L
    out_v = torch.empty((R, L + 1), dtype=vals.dtype, device=dev)
    out_i = torch.empty((R, L + 1), dtype=idx.dtype, device=dev)
    out_v.scatter_(1, t_row, vals)
    out_i.scatter_(1, t_row, idx)
    out_v.scatter_(1, t_ins, sv.to(vals.dtype))
    out_i.scatter_(1, t_ins, si.to(idx.dtype))
    return out_v[:, :L], out_i[:, :L]


def merge_insert_ref(vals: torch.Tensor, idx: torch.Tensor,
                     ins_vals: torch.Tensor, ins_idx: torch.Tensor,
                     ins_mask: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle from the definition: one stable sort of the concatenated
    (R, L + k) block, first k positions dropped."""
    k = ins_vals.shape[1]
    gated = torch.where(ins_mask, ins_vals.to(vals.dtype), NEG_INF)
    mvals = torch.cat([vals, gated], dim=1)
    midx = torch.cat([idx, ins_idx.to(idx.dtype)], dim=1)
    order = torch.sort(mvals, dim=1, stable=True).indices[:, k:]
    return (torch.gather(mvals, 1, order), torch.gather(midx, 1, order))


def merge_rows_ref(vals: torch.Tensor, idx: torch.Tensor,
                   ins_vals: torch.Tensor, ins_idx: torch.Tensor, *,
                   n_base: int, width: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What ``merge_rows_cuda`` computes for (b, L) ascending rows and
    their (b, k) inserts in burst order (ids ``ins_idx``, (k,) or (b, k)):
    entries with an id at or above ``n_base`` gated to (SENTINEL, -1); k
    head (SENTINEL, -1) entries put before the gated row, and the whole
    partitioned stably into the entries below SENTINEL, at it and above it
    (the stable ascending sort of that concatenation, since the row was
    ascending); the inserts merged in (``merge_sorted_ref``, the k smallest
    dropped); the (b, L + k) lists head-padded with (SENTINEL, -1) or
    head-trimmed to ``width``.  Returns (values, ids, reordered):
    reordered marks the rows in which a gated entry held a value other
    than SENTINEL, the rows the kernel partitions."""
    b, L = vals.shape
    k = ins_vals.shape[1]
    gated = idx >= n_base
    pad_v = torch.full((b, k), SENTINEL, dtype=vals.dtype, device=vals.device)
    pad_i = torch.full((b, k), -1, dtype=idx.dtype, device=idx.device)
    gv = torch.cat([pad_v, torch.where(gated, SENTINEL, vals)], dim=1)
    gi = torch.cat([pad_i, torch.where(gated, -1, idx)], dim=1)
    group = 2 - (gv <= SENTINEL).to(torch.int8) - (gv < SENTINEL).to(
        torch.int8)
    order = torch.sort(group, dim=1, stable=True).indices
    sv, so = torch.sort(ins_vals.to(vals.dtype).contiguous(), dim=1,
                        stable=True)
    si = torch.gather(ins_idx.to(idx.dtype).expand(b, k), 1, so)
    mv, mi = merge_sorted_ref(gv.gather(1, order), gi.gather(1, order), sv,
                              si)
    mv, mi = fit_width(mv, mi, width)
    reordered = (gated & (vals != SENTINEL)).any(dim=1)
    return mv, mi, reordered


def fit_width(vals: torch.Tensor, idx: torch.Tensor,
              width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad (head SENTINELs, id -1) or trim (head entries, SENTINELs by
    construction) ascending lists to ``width`` columns."""
    rows, cur = vals.shape
    if cur == width:
        return vals, idx
    if cur < width:
        pad_v = torch.full((rows, width - cur), SENTINEL, dtype=vals.dtype,
                           device=vals.device)
        pad_i = torch.full((rows, width - cur), -1, dtype=idx.dtype,
                           device=idx.device)
        return torch.cat([pad_v, vals], dim=1), torch.cat([pad_i, idx], dim=1)
    return vals[:, cur - width:], idx[:, cur - width:]
