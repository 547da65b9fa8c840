"""The plain reference: cosine similarity lists and kNN recommendations,
in plain PyTorch, and the comparisons that judge the program's answers.

It imports torch alone, never the program, and works everything out
again from the ratings the benchmark made.  Precisions:

  exact  float64 products of the raw ratings over float64 norms: the
         truth for the server's float32 arena (integer and half-star
         ratings make every product and sum exact)
  bfloat16
         rows normalised in float32 as the build states, rounded to
         bfloat16, products summed in float64: the truth at the build's
         stated precision
  tf32, fp8
         the same with operands rounded to TF32 (10 mantissa bits,
         round to nearest even) or float8 e4m3: the controls, one step
         below float32 with TF32 off and below bfloat16

Blocks of ``BLOCK_ROWS`` rows keep the float64 copies small on the card.
"""
from __future__ import annotations

import torch

SENTINEL_GATE = -1.5     # list entries at or below this are empty slots
EPS = 1e-12
BLOCK_ROWS = 4096


def _fp32_exact() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest
    even (finite inputs)."""
    bits = x.float().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def unit_rows(F: torch.Tensor) -> torch.Tensor:
    """Rows divided by their float32 norm (clamped at 1e-12), in float32:
    the normalisation the build states."""
    F = F.float()
    norms = torch.sqrt(torch.sum(F * F, dim=1)).clamp_min(EPS)
    return F / norms[:, None]


def operands(F: torch.Tensor, precision: str) -> torch.Tensor:
    """Rows as the product of ``precision`` takes them, in float64."""
    if precision == "exact":
        F = F.double()
        return F / torch.linalg.vector_norm(F, dim=1).clamp_min(EPS)[:, None]
    Fn = unit_rows(F)
    if precision == "bfloat16":
        Fn = Fn.to(torch.bfloat16)
    elif precision == "fp8":
        Fn = Fn.to(torch.float8_e4m3fn)
    elif precision == "tf32":
        Fn = round_tf32(Fn)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return Fn.double()


def cosine_rows(Q: torch.Tensor, F: torch.Tensor, precision: str
                ) -> torch.Tensor:
    """(b, n) float64 cosine similarities of the rows of ``Q`` against
    every row of ``F`` (both raw ratings, 0 = unrated).  ``exact``
    divides exact dot products by the norms; the others multiply rows
    normalised and rounded to ``precision``."""
    _fp32_exact()
    if precision == "exact":
        Qd = Q.double()
        qn = torch.linalg.vector_norm(Qd, dim=1).clamp_min(EPS)
        out = torch.empty((Q.shape[0], F.shape[0]), dtype=torch.float64,
                          device=Q.device)
        for r0 in range(0, F.shape[0], BLOCK_ROWS):
            Fd = F[r0:r0 + BLOCK_ROWS].double()
            fn = torch.linalg.vector_norm(Fd, dim=1).clamp_min(EPS)
            out[:, r0:r0 + BLOCK_ROWS] = (Qd @ Fd.T) / (qn[:, None]
                                                        * fn[None, :])
        return out
    Qo = operands(Q, precision)
    out = torch.empty((Q.shape[0], F.shape[0]), dtype=torch.float64,
                      device=Q.device)
    for r0 in range(0, F.shape[0], BLOCK_ROWS):
        out[:, r0:r0 + BLOCK_ROWS] = Qo @ operands(F[r0:r0 + BLOCK_ROWS],
                                                   precision).T
    return out


def expected_columns(rows: torch.Tensor, n_base: int) -> torch.Tensor:
    """How many leading columns each row's list covers: a base row (below
    ``n_base``) every base row, itself included; a row onboarded since
    the last rotation every row before its own slot."""
    return torch.where(rows < n_base, torch.full_like(rows, n_base), rows)


def list_errors(vals: torch.Tensor, idx: torch.Tensor,
                truth: torch.Tensor, cols: torch.Tensor) -> dict:
    """Judge sorted similarity lists by id.

    ``vals`` (b, W) ascending values with ``idx`` (b, W) their ids; row i
    must hold each id in ``[0, cols[i])`` exactly once above the sentinel
    gate and nothing else, each with the value ``truth[i, id]``.

    Returns the largest gap |value - truth| over every entry whose id is
    expected, the number of rows not sorted ascending, and the number of
    rows whose ids are not exactly the expected set."""
    b, W = vals.shape
    n = truth.shape[1]
    live = vals > SENTINEL_GATE
    ids = idx.long()
    in_range = (ids >= 0) & (ids < n)
    bad_id = (live & ~in_range).any(dim=1)
    slot = torch.where(live & in_range, ids, n)            # n = discard
    counts = torch.zeros((b, n + 1), dtype=torch.int32, device=vals.device)
    counts.scatter_add_(1, slot, torch.ones_like(slot, dtype=torch.int32))
    expected = (torch.arange(n, device=vals.device)[None, :]
                < cols[:, None].to(vals.device))
    id_rows = bad_id | (counts[:, :n] != expected.int()).any(dim=1)
    got = torch.zeros((b, n + 1), dtype=torch.float64, device=vals.device)
    got.scatter_(1, slot, vals.double())
    found = expected & (counts[:, :n] == 1)
    gap = torch.where(found, (got[:, :n] - truth).abs(), 0.0)
    unsorted = (vals[:, 1:] < vals[:, :-1]).any(dim=1)
    return {"gap": float(gap.max()) if gap.numel() else 0.0,
            "unsorted_rows": int(unsorted.sum()),
            "id_rows": int(id_rows.sum()),
            "rows": b}


def knn_scores(sims: torch.Tensor, cand: torch.Tensor, F: torch.Tensor,
               users: torch.Tensor, k: int, delta: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference kNN item scores for ``users`` (b,): neighbours are the k
    largest ``sims`` among ``cand`` (b, n) candidates, weighted by
    max(sim, 0); an item's score is sum(w r) / max(sum(w [r != 0]), EPS)
    in float64, the user's rated items at -inf.

    Also returns which rows are ambiguous: a k-th neighbour with positive
    similarity no more than ``delta`` above the (k+1)-th, so a rounding
    of the similarities may rightly pick another neighbour set."""
    s = torch.where(cand, sims, float("-inf"))
    kk = min(k + 1, s.shape[1])
    top, pos = torch.topk(s, kk, dim=1)
    kth = top[:, k - 1]
    nxt = top[:, k] if kk > k else torch.full_like(kth, float("-inf"))
    ambiguous = (kth > 0) & (kth - nxt <= delta)
    w = torch.where(torch.isfinite(top[:, :k]), top[:, :k], 0.0)
    w = w.clamp_min(0.0)
    nb = F[pos[:, :k]].double()                          # (b, k, m)
    ssum = torch.einsum("bk,bkm->bm", w, nb)
    dsum = torch.einsum("bk,bkm->bm", w, (nb != 0).double())
    scores = ssum / dsum.clamp_min(EPS)
    scores = torch.where(F[users] != 0, float("-inf"), scores)
    return scores, ambiguous


def recommendation_gaps(served: list, scores: torch.Tensor, n: int
                        ) -> dict:
    """Judge served recommendation lists against reference scores.

    ``served[i]`` is a list of (item, score) for the row whose reference
    scores are ``scores[i]`` (m,).  A row must hold ``n`` distinct items;
    the score gap is |served score - reference score of that item|, and
    the rank gap how far the worst served item's reference score lies
    below the reference's n-th best.  A seen item scores -inf in the
    reference, so it shows as an infinite gap."""
    score_gap = rank_gap = 0.0
    malformed = 0
    sc = scores.cpu()
    nth = torch.topk(sc, n, dim=1).values[:, n - 1]
    for i, recs in enumerate(served):
        items = [int(it) for it, _ in recs]
        if len(items) != n or len(set(items)) != n or not all(
                0 <= it < sc.shape[1] for it in items):
            malformed += 1
            continue
        ref = sc[i, items]
        got = torch.tensor([float(s) for _, s in recs], dtype=torch.float64)
        score_gap = max(score_gap, float((got - ref).abs().max()))
        rank_gap = max(rank_gap, float(nth[i] - ref.min()))
    return {"score_gap": score_gap, "rank_gap": max(rank_gap, 0.0),
            "malformed": malformed}


def served_from_reference(scores: torch.Tensor, n: int) -> list:
    """The reference's own top-n answer for each row, as served lists
    (what a control puts in the program's place)."""
    top = torch.topk(scores.cpu().float(), n, dim=1)
    return [[(int(it), float(s)) for s, it in zip(vals, items)]
            for vals, items in zip(top.values.tolist(),
                                   top.indices.tolist())]


def judge_lists(rows: torch.Tensor, F: torch.Tensor, cols: torch.Tensor,
                truth: str, vals: torch.Tensor | None = None,
                idx: torch.Tensor | None = None, control: str | None = None,
                block: int = 512) -> dict:
    """``list_errors`` over many rows in blocks: the lists ``vals``/``idx``
    of the rows ``rows`` of ``F`` (the ratings every row's list is over),
    or, with ``control``, the reference's own lists at that precision in
    their place, judged against ``truth``-precision similarities."""
    out = {"gap": 0.0, "unsorted_rows": 0, "id_rows": 0, "rows": 0}
    for b0 in range(0, rows.numel(), block):
        r = rows[b0:b0 + block]
        c = cols[b0:b0 + block]
        want = cosine_rows(F[r], F, truth)
        if control is None:
            v, i = vals[b0:b0 + block], idx[b0:b0 + block]
        else:
            v, i = sorted_lists(cosine_rows(F[r], F, control), c,
                                F.shape[0])
        e = list_errors(v, i, want, c)
        out["gap"] = max(out["gap"], e["gap"])
        for key in ("unsorted_rows", "id_rows", "rows"):
            out[key] += e[key]
    return out


def sorted_lists(sims: torch.Tensor, cols: torch.Tensor, width: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ascending (b, width) f32 lists of ``sims`` (b, n) over each row's
    first ``cols[i]`` columns, empty slots -2.0 at the head (what a
    control puts in the program's place)."""
    b, n = sims.shape
    live = torch.arange(n, device=sims.device)[None, :] < cols[:, None]
    v = torch.where(live, sims.float(), -2.0)
    vals, idx = torch.sort(v, dim=1, stable=True)
    if width > n:
        pad_v = torch.full((b, width - n), -2.0, device=v.device)
        pad_i = torch.full((b, width - n), -1, device=v.device,
                           dtype=idx.dtype)
        vals, idx = torch.cat([pad_v, vals], 1), torch.cat([pad_i, idx], 1)
    return vals, idx.to(torch.int32)
