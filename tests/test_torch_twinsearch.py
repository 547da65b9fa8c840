"""Port parity: TwinSearch (probe -> candidate mask -> verify -> copy)
against the JAX reference and the numpy oracle of Algorithm 1.

Tolerances: masks, found flags, candidate counts, overflow flags and twin
ids exact; probe similarities within 1e-6; onboarded lists under
``bridge.lists_match`` at 1e-6.  Probes are the JAX reference's, passed in
as arguments (the port never reseeds torch to chase them).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import twinsearch as jts
from repro.core.reference import build_sorted_lists_np, twinsearch_np
from repro_torch.bridge import lists_match, state_from_numpy, state_to_numpy
from repro_torch.core import set0_cap
from repro_torch.core import twinsearch as ts
from tests.conftest import make_ratings

torch.set_num_threads(2)

TOL = 1e-6


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


def _burst(R, rng):
    fresh = make_ratings(rng, n=3, m=R.shape[1])
    return np.concatenate([R[[3, 3, 17]], fresh[:1], fresh[:1], R[[40]],
                           fresh[1:]])                  # (8, m)


def test_find_parity_stepwise(rng):
    R = make_ratings(rng)
    js = jbuild(jnp.asarray(R), capacity_extra=8)
    st = state_from_numpy(_jstate_np(js), device="cpu")
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(0), 3, 4, 120))
    for p, r0 in zip(probes, (R[5], R[99], make_ratings(rng, n=1)[0])):
        jr0, jp = jnp.asarray(r0), jnp.asarray(p)
        tr0, tp = torch.as_tensor(r0), torch.tensor(p).long()
        js0 = np.asarray(jts.probe_sims(js, jr0, jp))
        s0 = ts.probe_sims(st, tr0, tp)
        np.testing.assert_allclose(s0.numpy(), js0, atol=TOL, rtol=0)
        jmask = np.asarray(jts.candidate_mask(js, jp, jnp.asarray(js0),
                                              TOL))
        tmask = ts.candidate_mask(st, tp, torch.tensor(js0), TOL)
        np.testing.assert_array_equal(tmask.numpy(), jmask)
        jout = jax.device_get(jts.verify_candidates(
            js, jr0, jnp.asarray(jmask), 8, 120, 8))
        tout = ts.verify_candidates(st, tr0, tmask, 8, 120, 8)
        assert [int(x) for x in tout] == [int(x) for x in jout]


@pytest.mark.parametrize("s_max", [2, 8])
def test_onboard_batch_parity(rng, s_max):
    """A burst with twins of base users, burst-internal twins and fresh
    users; s_max=2 forces candidate overflow on tie-heavy rows."""
    R = make_ratings(rng)
    R[50:56] = R[3]                       # six identical base users
    burst = _burst(R, np.random.default_rng(11))
    probes = np.asarray(jts.make_probes(jax.random.PRNGKey(1), 8, 4, 120))
    js = jbuild(jnp.asarray(R), capacity_extra=8)
    jst, jstats = jts.onboard_batch(js, jnp.asarray(burst),
                                    jnp.asarray(probes), s_max=s_max)
    tst, tstats = ts.onboard_batch(
        state_from_numpy(_jstate_np(js), device="cpu"),
        torch.as_tensor(burst), probes, s_max=s_max)
    for name in ("found", "twin_idx", "n_candidates", "overflowed"):
        np.testing.assert_array_equal(getattr(tstats, name).numpy(),
                                      np.asarray(getattr(jstats, name)),
                                      err_msg=name)
    j, t = _jstate_np(jst), state_to_numpy(tst)
    assert t["n_active"] == j["n_active"] == 128
    np.testing.assert_array_equal(t["ratings"], j["ratings"])
    np.testing.assert_array_equal(t["norms"], j["norms"])
    assert lists_match(j["sim_vals"], j["sim_idx"], t["sim_vals"],
                       t["sim_idx"], TOL) is None
    assert bool(tstats.found[0]) and bool(tstats.found[1])


def test_twin_against_numpy_oracle(rng):
    """Algorithm 1 on numpy sets and early-exit loops: same found flag and
    twin for twins and non-twins (the static cap is set above |Set_0|)."""
    R = make_ratings(rng, n=90, m=30)
    vals, idx = build_sorted_lists_np(R)
    st = state_from_numpy({"ratings": R, "norms": np.linalg.norm(R, axis=1),
                           "sim_vals": vals, "sim_idx": idx,
                           "n_active": 90}, device="cpu")
    gen = torch.Generator().manual_seed(0)
    for r0 in (R[12], R[60], make_ratings(rng, n=1, m=30)[0]):
        probes = ts.make_probes(gen, 1, 5, 90)[0]
        found, twin, set0 = twinsearch_np(R, vals, idx, r0, probes.numpy())
        res = ts.twinsearch_find(st, torch.as_tensor(r0), probes,
                                 s_max=set0_cap(90, minimum=90))
        assert bool(res.found) == found
        if found:
            assert int(res.twin_idx) == twin
        assert int(res.n_candidates) == len(set0)


def test_make_probes_same_on_every_device():
    a = ts.make_probes(torch.Generator().manual_seed(3), 4, 6, 50)
    b = ts.make_probes(torch.Generator().manual_seed(3), 4, 6, 50)
    assert a.shape == (4, 6) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 50
