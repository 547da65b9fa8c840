"""Seeded rating data, made on the device in a few large calls.

The rule is ``repro_torch.data.synth_ratings``' (and the JAX package's),
vectorised: power-law item popularity ``(j + 1) ** -alpha``, a normal
bias per user and per item, each user given ``min(floor, count // n)``
distinct items by popularity, then (user, item) pairs drawn uniformly
over users and by popularity over items, pairs already rated or repeated
within a round dropped, until the matrix holds exactly ``n_ratings``.
A value is ``mean + user bias + item bias + noise`` rounded to the
configuration's step (1 star, or half stars) and clipped to its range.

New users follow ``plant_twins``: a copy of a base user's row (a twin),
or a fresh profile of ``max(8, floor(0.002 * m))`` distinct items chosen
uniformly with values uniform over the rating scale.

Nothing here calls the program or writes to disk; the same seed gives the
same matrices on the same device.
"""
from __future__ import annotations

import math

import torch

FLOOR_CHUNK_ROWS = 4096      # users per Gumbel top-k call
MAX_ROUNDS = 64              # top-up rounds before giving up


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def rating_levels(cfg: dict) -> torch.Tensor:
    """Every value a rating may take, ascending (f32, CPU)."""
    lo, hi = cfg["rating_range"]
    step = cfg["rating_step"]
    n = int(round((hi - lo) / step)) + 1
    return lo + step * torch.arange(n, dtype=torch.float32)


def popularity(m: int, alpha: float, device) -> torch.Tensor:
    """(m,) f64 item probabilities, item 0 the most popular."""
    p = torch.arange(1, m + 1, dtype=torch.float64,
                     device=device).pow(-alpha)
    return p / p.sum()


def _values(cfg: dict, ub: torch.Tensor, ib: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
    g = cfg["generator"]
    lo, hi = cfg["rating_range"]
    step = cfg["rating_step"]
    raw = g["mean"] + ub + ib + g["noise_sd"] * noise
    return torch.clamp(torch.round(raw / step) * step, lo, hi)


def synth_ratings(cfg: dict, seed: int, device) -> torch.Tensor:
    """Dense (n_users, n_items) f32 ratings, 0 = unrated, with exactly
    ``n_ratings`` nonzeros and at least ``min(min_per_user, n_ratings //
    n_users)`` per user."""
    n, m, total = cfg["n_users"], cfg["n_items"], cfg["n_ratings"]
    g = cfg["generator"]
    if not n * min(cfg["min_per_user"], total // n) <= total <= n * m:
        raise ValueError(f"{total} ratings do not fit {n} x {m} with the "
                         f"floor of {cfg['min_per_user']}")
    gen = generator(device, seed)
    ub = g["user_bias_sd"] * torch.randn(n, generator=gen, device=device)
    ib = g["item_bias_sd"] * torch.randn(m, generator=gen, device=device)
    p = popularity(m, g["alpha"], device)
    R = torch.zeros((n, m), dtype=torch.float32, device=device)

    # The floor: ``base`` distinct items per user, drawn by popularity
    # without replacement (Gumbel top-k over log p).
    base = min(cfg["min_per_user"], total // n)
    logp = p.log().float()
    for u0 in range(0, n, FLOOR_CHUNK_ROWS):
        u1 = min(n, u0 + FLOOR_CHUNK_ROWS)
        u = torch.rand((u1 - u0, m), generator=gen, device=device)
        gumbel = -torch.log(-torch.log(u.clamp_(1e-20, 1.0 - 1e-7)))
        items = torch.topk(logp + gumbel, base, dim=1).indices
        del u, gumbel
        noise = torch.randn((u1 - u0, base), generator=gen, device=device)
        vals = _values(cfg, ub[u0:u1, None], ib[items], noise)
        R[u0:u1].scatter_(1, items, vals)

    # The top-up, in rounds, keeping the first draw of each new pair.
    cdf = torch.cumsum(p, 0)
    cdf[-1] = 1.0
    flat = R.view(-1)
    deficit = total - n * base
    for _ in range(MAX_ROUNDS):
        if deficit <= 0:
            break
        k = int(deficit * 1.25) + 4096
        us = torch.randint(0, n, (k,), generator=gen, device=device)
        draws = torch.rand(k, dtype=torch.float64, generator=gen,
                           device=device)
        its = torch.searchsorted(cdf, draws).clamp_max_(m - 1)
        noise = torch.randn(k, generator=gen, device=device)
        keys = us * m + its
        sk, order = torch.sort(keys, stable=True)
        first_sorted = torch.ones(k, dtype=torch.bool, device=device)
        first_sorted[1:] = sk[1:] != sk[:-1]
        first = torch.empty_like(first_sorted)
        first[order] = first_sorted
        keep = first & (flat[keys] == 0)
        keep &= torch.cumsum(keep, 0) <= deficit
        sel = keys[keep]
        flat[sel] = _values(cfg, ub[us[keep]], ib[its[keep]], noise[keep])
        deficit -= int(sel.numel())
    if deficit > 0:
        raise RuntimeError(f"top-up left {deficit} ratings unplaced after "
                           f"{MAX_ROUNDS} rounds")
    return R


def fresh_profiles(cfg: dict, k: int, gen: torch.Generator,
                   device) -> torch.Tensor:
    """(k, m) f32 fresh profiles: ``max(8, floor(0.002 m))`` distinct
    items each, chosen uniformly, values uniform over the rating scale."""
    m = cfg["n_items"]
    per = max(8, int(0.002 * m))
    out = torch.zeros((k, m), dtype=torch.float32, device=device)
    if k == 0:
        return out
    items = torch.topk(torch.rand((k, m), generator=gen, device=device),
                       per, dim=1).indices
    levels = rating_levels(cfg).to(device)
    pick = torch.randint(0, levels.numel(), (k, per), generator=gen,
                         device=device)
    out.scatter_(1, items, levels[pick])
    return out


def twin_pool(R: torch.Tensor, size: int, min_ratings: int,
              gen: torch.Generator) -> torch.Tensor:
    """(size,) base users with at least ``min_ratings`` ratings, drawn
    without replacement."""
    heavy = torch.nonzero((R != 0).sum(dim=1) >= min_ratings).flatten()
    if heavy.numel() < size:
        raise ValueError(f"only {heavy.numel()} users have >= "
                         f"{min_ratings} ratings; the pool needs {size}")
    pick = torch.randperm(heavy.numel(), generator=gen,
                          device=gen.device)[:size].to(heavy.device)
    return heavy[pick]


def to_coo(R: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A host copy of R's nonzeros: ((nnz, 2) int32 (row, col), (nnz,)
    values), for the reference after the program's state is gone."""
    nz = torch.nonzero(R)
    return nz.to(torch.int32).cpu(), R[nz[:, 0], nz[:, 1]].cpu()


def dense_rows(coo: tuple[torch.Tensor, torch.Tensor], n: int, m: int,
               device, dtype=torch.float32) -> torch.Tensor:
    """The (n, m) matrix back from ``to_coo``."""
    ij, v = coo
    R = torch.zeros((n, m), dtype=dtype, device=device)
    ij = ij.to(device).long()
    R[ij[:, 0], ij[:, 1]] = v.to(device, dtype)
    return R


def exponential_gaps(n: int, rate: float, seconds: float,
                     gen: torch.Generator) -> torch.Tensor:
    """(n,) Poisson inter-arrival gaps with the same multiset for every
    seed (the exponential's quantiles at (i + 0.5) / n, in a seeded
    order), scaled so the n arrivals span exactly ``seconds``."""
    q = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    gaps = -torch.log1p(-q) / rate
    gaps = gaps[torch.randperm(n, generator=gen)]
    return gaps * (seconds / float(gaps.sum())) if n else gaps


def due_times(mix: dict, n: int, seconds: float,
              gen: torch.Generator) -> list[float]:
    """The window's ``n`` due times (seconds from its start) under the
    mix's ``arrivals``: ``poisson`` (independent clients: the gaps of
    ``exponential_gaps``) or ``periodic`` (a batching front end that
    sends on a timer: ``n`` equal gaps over ``seconds``)."""
    kind = mix.get("arrivals", "poisson")
    if kind == "poisson":
        gaps = exponential_gaps(n, mix["rate_per_s"], seconds, gen)
    elif kind == "periodic":
        gaps = torch.full((n,), seconds / n, dtype=torch.float64)
    else:
        raise ValueError(f"unknown arrivals {kind!r}")
    due = torch.cumsum(gaps, 0)
    return (due - due[0]).tolist()


def zipf_ranks(n_draws: int, n_items: int, s: float,
               gen: torch.Generator) -> torch.Tensor:
    """(n_draws,) ranks in [0, n_items) under Zipf(s), from the stratified
    quantiles (i + 0.5) / n_draws in a seeded order: the same multiset of
    ranks for every seed."""
    w = torch.arange(1, n_items + 1, dtype=torch.float64).pow(-s)
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0
    q = (torch.arange(n_draws, dtype=torch.float64) + 0.5) / n_draws
    ranks = torch.searchsorted(cdf, q).clamp_max_(n_items - 1)
    return ranks[torch.randperm(n_draws, generator=gen)]


def count_requests(rate: float, seconds: float) -> int:
    return max(1, int(math.floor(rate * seconds + 0.5)))
