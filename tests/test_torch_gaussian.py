"""Port parity: ``repro_torch.core.gaussian`` (the paper's |Set_0|
analysis, Sec 3.2) against ``repro.core.gaussian`` on the same inputs,
exactly; the measurements also on torch tensors."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import gaussian as jg
from repro_torch.core import gaussian as tg

torch.set_num_threads(2)


def test_paper_fraction_is_one_over_125():
    assert tg.paper_fraction() == jg.paper_fraction()
    assert round(1 / tg.paper_fraction()) == 125


@pytest.mark.parametrize("n", [943, 129_490, 524_288])
def test_paper_bound(n):
    assert tg.paper_bound(n) == jg.paper_bound(n)


@pytest.mark.parametrize("mu,sigma,x", [(0.0, 0.25, 100), (0.3, 0.1, 100),
                                        (0.5, 0.2, 50), (2.0, 0.1, 10),
                                        (0.1, 0.05, 200)])
def test_exact_fraction_and_bound(mu, sigma, x):
    assert tg.exact_fraction(mu, sigma, x) == jg.exact_fraction(mu, sigma, x)
    assert tg.exact_bound(1000, mu, sigma, x) == jg.exact_bound(1000, mu,
                                                                sigma, x)


@pytest.mark.parametrize("seed,x", [(0, 100), (1, 20), (2, 7)])
def test_empirical_max_sublist(seed, x):
    row = np.random.default_rng(seed).normal(0.3, 0.2, 500).astype(
        np.float32)
    want = jg.empirical_max_sublist(row, x)
    assert tg.empirical_max_sublist(row, x) == want
    assert tg.empirical_max_sublist(torch.as_tensor(row), x) == want


@pytest.mark.parametrize("seed,tol", [(0, 1e-6), (3, 0.05), (4, 0.2)])
def test_empirical_set0(seed, tol):
    rng = np.random.default_rng(seed)
    rows = np.round(rng.random((4, 300)), 1).astype(np.float32)
    sims0 = rows[:, 7].copy()
    want = jg.empirical_set0(rows, sims0, tol)
    assert tg.empirical_set0(rows, sims0, tol) == want
    assert tg.empirical_set0(torch.as_tensor(rows), torch.as_tensor(sims0),
                             tol) == want
    assert want >= 1
