"""The plain reference for bursts of new rows over an immutable base, and
the comparisons that judge what a burst step answered.

A burst is k new rows.  Row j's list must hold, sorted ascending and each
id once, its cosine similarity with every base row (ids ``[0, n_base)``)
and with every earlier row of its burst (id ``n_base + s`` for s < j);
the later slots of the burst are empty (at or below the sentinel gate).
Row j has a twin when it equals a base row or an earlier row of its
burst, exactly.

It imports torch and the benchmark's own reference alone, never the
program, and works everything out again from the base ratings the
benchmark made and the rows it sent.
"""
from __future__ import annotations

import torch

from cfbench.reference import cosine_rows, list_errors, sorted_lists

SENTINEL = -2.0
# A base row is a candidate twin where the exact cosine is this close to 1
# (or both rows are empty); equality is then tested exactly.
TWIN_COSINE = 1.0 - 1e-9
Q_BLOCK = 512


def burst_columns(n_base: int, k: int, device) -> torch.Tensor:
    """How many leading columns row j's list covers: the base and the
    burst's first j rows."""
    return n_base + torch.arange(k, device=device)


def burst_truth(base_cos: torch.Tensor, R_new: torch.Tensor,
                precision: str) -> torch.Tensor:
    """(k, n_base + k) float64 similarities of the burst's rows: ``base_cos``
    (k, n_base) against the base, then against the burst's own rows."""
    return torch.cat([base_cos, cosine_rows(R_new, R_new, precision)], 1)


def base_cosines(F: torch.Tensor, rows: list[torch.Tensor], precision: str
                 ) -> list[torch.Tensor]:
    """Each (k_i, m) host tensor of ``rows`` against every row of the base
    ``F`` (n_base, m) on its device, at ``precision``; rows that repeat
    within one tensor are computed once."""
    uniq, inv = zip(*(torch.unique(r, dim=0, return_inverse=True)
                      for r in rows))
    Q = torch.cat(uniq)
    out = torch.cat([cosine_rows(Q[q0:q0 + Q_BLOCK].to(F.device), F,
                                 precision)
                     for q0 in range(0, Q.shape[0], Q_BLOCK)])
    res, q0 = [], 0
    for u, i in zip(uniq, inv):
        res.append(out[q0 + i.to(out.device)])
        q0 += u.shape[0]
    return res


def _earlier_twins(R: torch.Tensor) -> list[bool]:
    """Row j equals an earlier row of the burst, exactly."""
    return [bool((R[:j] == R[j]).all(dim=1).any()) for j in range(R.shape[0])]


def expected_twins(F: torch.Tensor, R_new: torch.Tensor,
                   base_cos: torch.Tensor) -> torch.Tensor:
    """(k,) bool: row j equals a base row or an earlier row of the burst,
    exactly.  ``base_cos`` (k, n_base) exact cosines pick the base rows
    worth comparing."""
    R = R_new.to(F.device)
    empty = (R != 0).sum(dim=1) == 0
    base_empty = (F != 0).sum(dim=1) == 0 if bool(empty.any()) else None
    out = torch.tensor(_earlier_twins(R))
    for j in torch.nonzero(~out).flatten().tolist():
        cand = base_cos[j] >= TWIN_COSINE
        if bool(empty[j]):
            cand = cand | base_empty
        ids = torch.nonzero(cand).flatten()
        out[j] = ids.numel() > 0 and bool((F[ids] == R[j]).all(dim=1).any())
    return out


def expected_lists(F: torch.Tensor, R_new: torch.Tensor,
                   precision: str = "exact"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The lists one burst's rows should get: (k, n_base + k) float32
    values ascending and int32 ids, later burst slots empty."""
    n_base, k = F.shape[0], R_new.shape[0]
    (cos,) = base_cosines(F, [R_new], precision)
    truth = burst_truth(cos, R_new.to(F.device), precision)
    return sorted_lists(truth, burst_columns(n_base, k, F.device),
                        n_base + k)


def by_id(vals: torch.Tensor, idx: torch.Tensor, width: int) -> torch.Tensor:
    """(b, width) list values placed at their ids below ``width``; ids the
    lists do not hold read as empty."""
    out = torch.full((vals.shape[0], width), SENTINEL, dtype=vals.dtype,
                     device=vals.device)
    ids = idx.long()
    keep = (ids >= 0) & (ids < width)
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
    out[rows.expand_as(ids)[keep], ids[keep]] = vals[keep]
    return out


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def judge_burst(F: torch.Tensor, burst: dict, base_cos: torch.Tensor,
                copied: dict, control: str | None = None,
                control_cos: torch.Tensor | None = None) -> dict:
    """One burst's answers against the reference.

    ``burst``: ``R_new`` (k, m) the rows sent; ``vals``, ``idx`` the
    program's lists; ``found``, ``twin``, ``overflowed`` (k,) its stats.
    ``copied`` maps a base id to that row's stored list by id (n_base,).
    With ``control``, the reference's own lists at that precision
    (``control_cos`` against the base) stand in for the program's.

    Counts: ``shape`` (lists not (k, n_base + k)); the largest value gap
    and the unsorted and wrong-id rows (``list_errors``); ``flags``, rows
    flagged otherwise than exact equality says or naming a twin that is
    not an identical row (a twin missed because the candidate set
    overflowed is excused); ``copies``, rows whose values at the base ids
    are not bit-equal to the list they name as twin (an earlier row, or a
    base row's stored list), and later rows naming no twin that differ
    from the first row."""
    dev = F.device
    n_base = F.shape[0]
    R_new = burst["R_new"].to(dev)
    k = R_new.shape[0]
    W = n_base + k
    vals, idx = burst["vals"], burst["idx"]
    res = {"shape": 0, "gap": 0.0, "unsorted_rows": 0, "id_rows": 0,
           "flags": 0, "copies": 0, "rows": k}
    if tuple(vals.shape) != (k, W) or tuple(idx.shape) != (k, W):
        res["shape"] = 1
        return res
    cols = burst_columns(n_base, k, dev)
    truth = burst_truth(base_cos, R_new, "exact")
    if control is None:
        v, i = vals, idx
    else:
        v, i = sorted_lists(burst_truth(control_cos, R_new, control), cols,
                            W)
    e = list_errors(v, i, truth, cols)
    res.update(gap=e["gap"], unsorted_rows=e["unsorted_rows"],
               id_rows=e["id_rows"])

    found = burst["found"].bool().tolist()
    twin = burst["twin"].long().tolist()
    ovf = burst["overflowed"].bool().tolist()
    want = expected_twins(F, R_new, base_cos).tolist()
    earlier = _earlier_twins(R_new)
    listed = by_id(vals, idx, n_base)
    for j in range(k):
        if found[j]:
            t = twin[j]
            if t < n_base:
                ok = 0 <= t and torch.equal(F[t], R_new[j])
                source = copied.get(t)
            else:
                s = t - n_base
                ok = 0 <= s < j and torch.equal(R_new[s], R_new[j])
                source = listed[s] if ok else None
            res["flags"] += int(not ok or not want[j])
            if source is None or not _same_bits(listed[j], source):
                res["copies"] += 1
        else:
            excused = want[j] and not earlier[j] and ovf[j]
            res["flags"] += int(want[j] and not excused)
            if j > 0 and not _same_bits(listed[j], listed[0]):
                res["copies"] += 1
    return res


def judge(F: torch.Tensor, bursts: list[dict], copied: dict,
          control: str | None = None) -> dict:
    """``judge_burst`` over every burst, the counts summed and the gap the
    largest; ``bursts`` and ``copied`` as there."""
    rows = [b["R_new"] for b in bursts]
    exact = base_cosines(F, rows, "exact")
    ctrl = base_cosines(F, rows, control) if control else [None] * len(rows)
    out = {"shape": 0, "gap": 0.0, "unsorted_rows": 0, "id_rows": 0,
           "flags": 0, "copies": 0, "rows": 0, "bursts": len(bursts)}
    for b, cos, ccos in zip(bursts, exact, ctrl):
        r = judge_burst(F, b, cos, copied, control, ccos)
        out["gap"] = max(out["gap"], r.pop("gap"))
        for key, val in r.items():
            out[key] += val
    return out


def bit_digest(t: torch.Tensor, rows: int = 1024) -> int:
    """A sum of the tensor's 32-bit words, a block of rows at a time (no
    (n, m) int64 copy): equal before and after for a tensor left as it
    was."""
    words = t.reshape(t.shape[0], -1).view(torch.int32)
    return sum(int(words[r0:r0 + rows].sum(dtype=torch.int64))
               for r0 in range(0, words.shape[0], rows))

