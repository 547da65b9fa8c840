"""Port parity: ``core/update.py`` (``init_cache``, ``add_rating``) against
``repro.core.update`` on the CPU.

Tolerances: none.  Ratings are integers, so every dot product and squared
norm is an exact integer below 2^24, and the port keeps the reference's
order of operations: ratings, norms, lists, ids and the cache must be
bit-identical.  "Matches rebuild" (from ``tests/test_core_extras.py``)
holds the refreshed row to a fresh build within 1e-4, as the reference's
test does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import update as jupd
from repro_torch.bridge import state_from_numpy, state_to_numpy
from repro_torch.core import build_state, update
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _jnp_state(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


@pytest.mark.parametrize("updates", [
    [(7, 3, 5.0)],                                # set
    [(5, 2, 4.0), (5, 2, 1.0)],                   # set, then change
    [(5, 2, 4.0), (5, 2, 0.0), (11, 0, 0.0)],     # remove (incl. unrated)
    [(0, 1, 2.0), (39, 4, 3.0), (3, 9, 5.0)],     # several users
])
def test_add_rating_matches_reference(rng, updates):
    R = make_ratings(rng, n=40, m=15)
    js = jbuild(jnp.asarray(R), capacity_extra=4)    # masked free slots
    jc = jupd.init_cache(js.ratings)
    ts = state_from_numpy(_jnp_state(js), device="cpu")
    tc = update.init_cache(ts.ratings)
    np.testing.assert_array_equal(tc.dots.numpy(), np.asarray(jc.dots))
    np.testing.assert_array_equal(tc.sq.numpy(), np.asarray(jc.sq))
    for u, i, v in updates:
        js, jc = jupd.add_rating(js, jc, jnp.int32(u), jnp.int32(i),
                                 jnp.float32(v))
        ts2, tc2 = update.add_rating(ts, tc, u, i, v)
        assert ts2.ratings is ts.ratings and tc2.dots is tc.dots  # in place
        ts, tc = ts2, tc2
    t, j = state_to_numpy(ts), _jnp_state(js)
    for key in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
    assert int(t["n_active"]) == int(j["n_active"])
    np.testing.assert_array_equal(tc.dots.numpy(), np.asarray(jc.dots))
    np.testing.assert_array_equal(tc.sq.numpy(), np.asarray(jc.sq))


def test_add_rating_matches_rebuild(rng):
    R = make_ratings(rng, n=40, m=15)
    state = build_state(torch.as_tensor(R))
    cache = update.init_cache(state.ratings)
    state2, cache2 = update.add_rating(state, cache, 7, 3, 5.0)
    R2 = R.copy()
    R2[7, 3] = 5.0
    ref = build_state(torch.as_tensor(R2))
    np.testing.assert_allclose(state2.sim_vals[7].numpy(),
                               ref.sim_vals[7].numpy(), atol=1e-4)
    np.testing.assert_allclose(cache2.dots.numpy(),
                               R2.astype(np.float64) @ R2.T.astype(
                                   np.float64), atol=1e-2)


def test_remove_rating(rng):
    R = make_ratings(rng, n=30, m=12)
    R[5, 2] = 4.0
    state = build_state(torch.as_tensor(R))
    cache = update.init_cache(state.ratings)
    state2, _ = update.add_rating(state, cache, 5, 2, 0.0)
    assert float(state2.ratings[5, 2]) == 0.0


def test_server_cache_covers_users_onboarded_after_it(rng):
    """Onboarding appends rows without touching the dots cache.  The
    reference then scores a later add_rating against those users with a
    cached squared norm of 0 (similarities near 1e11); the port refreshes
    the rows first, so the result equals a cache seeded after the
    onboards, bit for bit, and every similarity is a cosine."""
    from repro_torch.serving import CFServer, ServerConfig
    R = make_ratings(rng, n=30, m=12)
    fresh = make_ratings(np.random.default_rng(3), n=3, m=12)
    servers = [CFServer(R, ServerConfig(capacity_extra=8, c_probes=4),
                        device="cpu") for _ in range(2)]
    for k, srv in enumerate(servers):
        assert srv.add_rating(4, 1, 5.0)        # seeds the cache
        for r in (R[2], *fresh):
            assert srv.onboard_user(r).ok
        if k == 1:
            srv._cache = None                   # re-seed after onboards
        assert srv.add_rating(7, 3, 2.0) and srv.add_rating(31, 0, 4.0)
    a, b = (state_to_numpy(s.state) for s in servers)
    for key in ("ratings", "norms", "sim_vals", "sim_idx"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["sim_vals"].max() <= 1.0 + 1e-6
