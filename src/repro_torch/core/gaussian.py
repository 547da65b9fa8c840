"""The paper's |Set_0| analysis (Sec 3.2, Eq. 3-4) + an exact re-derivation.

The paper models any user's similarity-list values as Gaussian with support
[0, 1] ⊂ [μ−4σ, μ+4σ], partitions [0, 1] into x equal sub-lists, and bounds
|Set_0| by the largest sub-list's mass:

    s = (Φ(k3) + Φ(k4) − 1) / (Φ(k1) + Φ(k2) − 1) · n          (Eq. 3)

maximised subject to μ−k1σ=0, μ+k2σ=1, μ−k3σ=0, μ+k4σ=1/x, 0≤k≤4 (Eq. 4).
The paper states the optimum k1=k3=0, k2=4, k4=0.01 giving s = n/125.

Note: the stated optimum is internally inconsistent — k1=0, k2=4 forces μ=0, σ=1/4, under which μ+k4σ=1/x with
x=100 gives k4=0.04 (s = n/31), not k4=0.01.  Taking the paper's k-values at
face value reproduces n/125; ``exact_bound`` evaluates Eq. 3 consistently for
any (μ, σ, x) and ``empirical_max_sublist`` measures the real quantity on
data.  The framework's static candidate cap keeps the paper's n/125 with a
slack factor, plus an overflow-checked fallback, so either reading is safe.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm


def _host(x) -> np.ndarray:
    """A torch tensor on any device, or anything ``np.asarray`` takes, as a
    host array (the measurements below run in numpy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def paper_fraction() -> float:
    """Eq. 3 evaluated at the paper's stated optimum (k1=k3=0, k2=4,
    k4=0.01) — the 1/125 constant."""
    k1, k2, k3, k4 = 0.0, 4.0, 0.0, 0.01
    return (norm.cdf(k3) + norm.cdf(k4) - 1) / (norm.cdf(k1) + norm.cdf(k2) - 1)


def paper_bound(n: int) -> float:
    return paper_fraction() * n


def exact_fraction(mu: float, sigma: float, x: int = 100) -> float:
    """Largest sub-list mass fraction for an actual N(mu, sigma) truncated to
    [0, 1], partitioned into x equal-width sub-lists (consistent Eq. 3)."""
    total = norm.cdf((1 - mu) / sigma) - norm.cdf((0 - mu) / sigma)
    if total <= 0:
        return 0.0
    edges = np.linspace(0.0, 1.0, x + 1)
    mass = norm.cdf((edges[1:] - mu) / sigma) - norm.cdf((edges[:-1] - mu) / sigma)
    return float(mass.max() / total)


def exact_bound(n: int, mu: float, sigma: float, x: int = 100) -> float:
    return exact_fraction(mu, sigma, x) * n


def empirical_max_sublist(sim_row, x: int = 100) -> int:
    """Measured largest sub-list size of one user's similarity list (an
    array or a tensor on any device)."""
    vals = _host(sim_row).astype(np.float64)
    vals = vals[(vals >= 0.0) & (vals <= 1.0)]
    hist, _ = np.histogram(vals, bins=x, range=(0.0, 1.0))
    return int(hist.max())


def empirical_set0(sim_rows, sims0, tol: float) -> int:
    """Measured |Set_0| for given probe rows/values (arrays or tensors on
    any device) — the quantity the static cap must dominate."""
    sim_rows, sims0 = _host(sim_rows), _host(sims0)
    masks = np.abs(sim_rows - sims0[:, None]) <= tol
    return int(np.all(masks, axis=0).sum())
