"""The port's copy of the NumPy transcription of Algorithm 1
(``repro_torch.core.reference``) equals ``repro.core.reference`` exactly,
and serves as a second oracle for the port's ``twinsearch_find``: found,
twin and Set_0 agree for planted twins and fresh rows.

The port's lists are built in fp32 and the oracle's in float64, so the
oracle runs on the port's own lists (Set_0 is a function of the lists and
the probe sims); on integer ratings a planted twin's probe sims are equal
in both.  ``twinsearch_find`` caps Set_0 at ``s_max``; the tests size
``s_max`` above the candidate count, as the oracle has no cap."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro_torch.core import build_state, twinsearch_find
from repro_torch.core import reference as tref
from tests.conftest import make_ratings

torch.set_num_threads(2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_copy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    R = make_ratings(rng, n=50, m=20)
    r0 = R[7].copy()
    np.testing.assert_array_equal(tref.cosine_vs_all_np(R, r0),
                                  jref.cosine_vs_all_np(R, r0))
    tv, ti = tref.build_sorted_lists_np(R)
    jv, ji = jref.build_sorted_lists_np(R)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
    probes = rng.choice(50, size=5, replace=False)
    for row in (R[7], R[30], make_ratings(rng, n=1, m=20)[0]):
        assert tref.twinsearch_np(R, tv, ti, row, probes) == \
            jref.twinsearch_np(R, jv, ji, row, probes)


def _set0(mask: torch.Tensor) -> set[int]:
    return set(torch.nonzero(mask).flatten().tolist())


@pytest.mark.parametrize("seed,n,m,c", [(0, 120, 40, 4), (1, 80, 30, 6),
                                        (2, 200, 24, 8)])
def test_twinsearch_find_agrees_with_oracle(seed, n, m, c):
    from repro_torch.core.twinsearch import candidate_mask, probe_sims
    rng = np.random.default_rng(seed)
    R = make_ratings(rng, n=n, m=m)
    R[n - 5] = R[11]                      # a row with two twins
    st = build_state(torch.as_tensor(R))
    vals, idx = st.sim_vals.numpy(), st.sim_idx.numpy()
    fresh = make_ratings(np.random.default_rng(seed + 9), n=2, m=m)
    for row in (R[11], R[3], R[n // 2], fresh[0], fresh[1]):
        probes = rng.choice(n, size=c, replace=False)
        found, twin, set0 = tref.twinsearch_np(R, vals, idx, row, probes)
        res = twinsearch_find(st, torch.as_tensor(row), probes, s_max=n)
        assert bool(res.found) == found
        if found:
            assert int(res.twin_idx) == twin
            assert np.array_equal(R[twin], row)
        sims0 = probe_sims(st, torch.as_tensor(row), torch.as_tensor(probes))
        cand = candidate_mask(st, torch.as_tensor(probes), sims0, 1e-6)
        assert _set0(cand) == set0
        assert int(res.n_candidates) == len(set0)
