"""Port parity: the k-way merge-insert and the list-maintenance module
against the JAX reference.

Tolerance: none.  The merge is data movement, so values and ids must be
bit-identical to the JAX wrapper (both its XLA path and its Pallas kernel
in interpret mode) and to the JAX ``ref.py``; the maintenance ops are fed
the same JAX-built state through the bridge and must be bit-identical too.
The kernel itself is held to its plain version on the card in
``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import build_state as jbuild
from repro.core import maintenance as jmaint
from repro.kernels.list_merge.ops import merge_insert as jmerge
from repro.kernels.list_merge.ref import merge_insert_ref as jmerge_ref
from repro_torch.bridge import state_from_numpy
from repro_torch.core import maintenance
from repro_torch.kernels import launch_counts
from repro_torch.kernels.list_merge.ops import merge_insert
from repro_torch.kernels.list_merge.ref import merge_insert_ref
from tests.conftest import make_ratings

torch.set_num_threads(2)


def _merge_case(rng, R, L, k):
    """Sorted rows with SENTINEL heads and -1 ids + duplicate-heavy inserts
    (ties with row entries and between inserts) and masked lanes."""
    pool = np.concatenate([[-2.0, -2.0], np.round(rng.uniform(-1, 1, 8), 2)])
    vals = np.sort(rng.choice(pool, size=(R, L)).astype(np.float32), axis=1)
    idx = np.stack([rng.permutation(L).astype(np.int32) for _ in range(R)])
    idx[vals == -2.0] = -1
    ins_vals = np.round(rng.uniform(-1.9, 1, (R, k)), 2).astype(np.float32)
    ins_vals[0, 0] = vals[0, L // 2]
    if k > 1:
        ins_vals[:, 1] = ins_vals[:, 0]
    ins_idx = np.ascontiguousarray(np.broadcast_to(
        1000 + np.arange(k, dtype=np.int32), (R, k)))
    ins_mask = rng.random((R, k)) < 0.7
    return vals, idx, ins_vals, ins_idx, ins_mask


CASES = [(5, 12, 3), (9, 33, 7), (16, 64, 1), (3, 8, 8), (11, 130, 30)]


@pytest.mark.parametrize("R,L,k", CASES)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_merge_insert_parity(R, L, k, use_pallas):
    case = _merge_case(np.random.default_rng(R * 1000 + L + k), R, L, k)
    jv, ji = jmerge(*map(jnp.asarray, case), use_pallas=use_pallas)
    before = launch_counts()["list_merge"]
    tv, ti = merge_insert(*map(torch.as_tensor, case))
    assert launch_counts()["list_merge"] == before     # plain version ran
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    rv, ri = jmerge_ref(*map(jnp.asarray, case))
    assert np.array_equal(tv.numpy(), np.asarray(rv))
    assert np.array_equal(ti.numpy(), np.asarray(ri))


@pytest.mark.parametrize("R,L,k", CASES)
def test_rank_scatter_equals_stable_sort_oracle(R, L, k):
    case = _merge_case(np.random.default_rng(R + L * 7 + k), R, L, k)
    tv, ti = merge_insert(*map(torch.as_tensor, case))
    ov, oi = merge_insert_ref(*map(torch.as_tensor, case))
    assert torch.equal(tv, ov) and torch.equal(ti, oi)


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


def _state_pair(rng, n=60, m=20, extra=6):
    R = make_ratings(rng, n=n, m=m)
    R[7] = R[3]                                    # tie-heavy: twins
    js = jbuild(jnp.asarray(R), capacity_extra=extra)
    return js, state_from_numpy(_jstate_np(js), device="cpu")


def test_insert_batch_into_lists_parity(rng):
    js, ts = _state_pair(rng)
    new_users = np.array([60, 61, 62], np.int32)
    block = np.round(np.random.default_rng(1).uniform(-1, 1, (3, 66)),
                     2).astype(np.float32)
    jo = jmaint.insert_batch_into_lists(js, jnp.asarray(new_users),
                                        jnp.asarray(block), use_pallas=True)
    to = maintenance.insert_batch_into_lists(ts, new_users,
                                             torch.as_tensor(block))
    assert np.array_equal(to.sim_vals.numpy(), np.asarray(jo.sim_vals))
    assert np.array_equal(to.sim_idx.numpy(), np.asarray(jo.sim_idx))


def test_splice_twins_and_single_insert_parity(rng):
    js, ts = _state_pair(rng)
    twins = np.array([3, 7, 11], np.int32)
    new_users = np.array([60, 61, 62], np.int32)
    assert np.array_equal(
        maintenance.twin_sims_block(ts, twins).numpy(),
        np.asarray(jmaint.twin_sims_block(js, jnp.asarray(twins))))
    jo = jmaint.splice_twins(js, jnp.asarray(new_users), jnp.asarray(twins))
    to = maintenance.splice_twins(ts, new_users, twins)
    assert np.array_equal(to.sim_vals.numpy(), np.asarray(jo.sim_vals))
    assert np.array_equal(to.sim_idx.numpy(), np.asarray(jo.sim_idx))
    jo = jmaint.splice_twin(js, jnp.int32(59), jnp.int32(3))
    to = maintenance.splice_twin(ts, 59, 3)
    assert np.array_equal(to.sim_vals.numpy(), np.asarray(jo.sim_vals))
    assert np.array_equal(to.sim_idx.numpy(), np.asarray(jo.sim_idx))


def test_merge_new_users_into_base_parity(rng):
    js, ts = _state_pair(rng)
    block = np.round(np.random.default_rng(2).uniform(-1, 1, (4, 66)),
                     2).astype(np.float32)
    ids = np.arange(66, 70, dtype=np.int32)
    jv, ji = jmaint.merge_new_users_into_base(
        js.sim_vals, js.sim_idx, jnp.asarray(block), jnp.asarray(ids),
        use_pallas=True)
    tv, ti = maintenance.merge_new_users_into_base(
        ts.sim_vals, ts.sim_idx, torch.as_tensor(block), ids)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert np.array_equal(ti.numpy(), np.asarray(ji))

