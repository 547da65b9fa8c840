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
from repro_torch.core.types import SENTINEL
from repro_torch.kernels import launch_counts
from repro_torch.kernels.list_merge import ref as merge_ref
from repro_torch.kernels.list_merge.ops import merge_insert, merge_rows
from repro_torch.kernels.list_merge.ref import fit_width, merge_insert_ref
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



# ---------------------------------------------------------------------------
# The rotation's base-row merge (``merge_rows``): gate, stable partition,
# head pad, merge and fit, against the route it replaced
# ---------------------------------------------------------------------------

def _old_route(vals, idx, ins, ids, n_base, width):
    """The rotation's merge before ``merge_rows``: gate, stable sort, gather,
    k head (SENTINEL, -1) columns, the merge-insert, then the fit to
    ``width``.  Also returns the stable sort's order."""
    gate = idx < n_base
    gv = torch.where(gate, vals, SENTINEL)
    gi = torch.where(gate, idx, -1)
    gv, order = torch.sort(gv, dim=1, stable=True)
    gi = torch.gather(gi, 1, order)
    b, k = ins.shape
    mv, mi = merge_insert_ref(
        torch.cat([torch.full((b, k), SENTINEL), gv], dim=1),
        torch.cat([torch.full((b, k), -1, dtype=torch.int32), gi], dim=1),
        ins, ids.expand(b, k), torch.ones((b, k), dtype=torch.bool))
    return (*fit_width(mv, mi, width), order)


@pytest.mark.parametrize("width", [3, 5, 8])
def test_fit_width_pads_and_trims_the_head(width):
    """``fit_width`` head-pads with (SENTINEL, -1), head-trims, or returns
    the lists as they are, written out by hand."""
    v = torch.tensor([[SENTINEL, SENTINEL, 0.1, 0.5, 0.9]])
    i = torch.tensor([[-1, 4, 2, 0, 1]], dtype=torch.int32)
    fv, fi = fit_width(v, i, width)
    pad = max(0, width - 5)
    want_v = torch.cat([torch.full((1, pad), SENTINEL), v], dim=1)
    want_i = torch.cat([torch.full((1, pad), -1, dtype=torch.int32), i],
                       dim=1)
    assert torch.equal(fv, want_v[:, -width:])
    assert torch.equal(fi, want_i[:, -width:])


def _rows_case(rng, b, L, k, n_base):
    """b ascending rows over SENTINEL heads (a few values below SENTINEL,
    ties everywhere), ids a permutation of the columns with -1 at half the
    SENTINEL slots; rows 1, 4, ... keep every id at or above ``n_base`` on
    SENTINEL entries (onboarding's rows), the others hold gated real values
    in their middle.  Inserts tie with row entries, with each other and
    with SENTINEL."""
    pool = np.concatenate([[-2.5, -2.0, -2.0, -2.0],
                           np.round(rng.uniform(-1, 1, 6), 2)])
    vals = np.sort(rng.choice(pool, size=(b, L)).astype(np.float32), axis=1)
    idx = np.stack([rng.permutation(L).astype(np.int32) for _ in range(b)])
    idx[(vals == -2.0) & (rng.random((b, L)) < 0.5)] = -1
    if n_base:
        keep = (np.arange(b) % 3 == 1)[:, None] & (vals != -2.0)
        idx[keep & (idx >= n_base)] %= n_base
    ins = np.round(rng.uniform(-2.2, 1, (b, k)), 2).astype(np.float32)
    ins[rng.random((b, k)) < 0.2] = -2.0
    ins[0, 0] = vals[0, L // 2]
    if k > 1:
        ins[:, 1] = ins[:, 0]
    return vals, idx, ins


@pytest.mark.parametrize("n_base", ["zero", "middle", "L"])
@pytest.mark.parametrize("fit", [5, 0, -3])
@pytest.mark.parametrize("k", [1, 64, 333])
def test_merge_rows_equals_the_old_route(k, fit, n_base):
    """Bit for bit the old route, rows written in place of an arena's rows
    (a slice and a list of rows), nothing else written; the counter counts
    the rows with a gated real value, and every other row's stable sort
    moved nothing."""
    b, L = 7, 97
    n_base = {"zero": 0, "middle": 64, "L": L}[n_base]
    W = L + k + fit
    rng = np.random.default_rng(k * 100 + fit + n_base)
    vals, idx, ins = map(torch.as_tensor, _rows_case(rng, b, L, k, n_base))
    ids = torch.arange(500, 500 + k, dtype=torch.int32)
    ev, ei, order = _old_route(vals, idx, ins, ids, n_base, W)
    gated_real = ((idx >= n_base) & (vals != SENTINEL)).any(dim=1)
    assert torch.equal(order[~gated_real],
                       torch.arange(L).expand(b, L)[~gated_real])
    if n_base == L:
        assert not gated_real.any()
    else:                        # the middle case keeps onboarding's rows
        assert gated_real.any() and (n_base == 0 or not gated_real.all())
    assert merge_ref.SENTINEL == SENTINEL
    N = b + 2                                   # rows 0 and N - 1 not merged
    arena_v = torch.cat([torch.zeros(1, L), vals, torch.zeros(1, L)])
    arena_i = torch.cat([torch.zeros(1, L, dtype=torch.int32), idx,
                         torch.zeros(1, L, dtype=torch.int32)])
    U = torch.cat([torch.zeros(k, 1), ins.T, torch.zeros(k, 1)], dim=1)
    for rows in (slice(1, N - 1), list(range(N - 2, 0, -1))):
        out_v = torch.full((N, W), 7.0)
        out_i = torch.full((N, W), 7, dtype=torch.int32)
        count = torch.zeros(1, dtype=torch.int32)
        before = launch_counts()["list_merge"]
        merge_rows(arena_v, arena_i, U, ids, rows, out_v, out_i,
                   n_base=n_base, reordered=count)
        assert launch_counts()["list_merge"] == before  # plain version ran
        assert torch.equal(out_v[1:-1], ev) and torch.equal(out_i[1:-1], ei)
        assert (out_v[[0, -1]] == 7.0).all() and (out_i[[0, -1]] == 7).all()
        assert int(count) == int(gated_real.sum())


@pytest.mark.parametrize("wide", ["idx", "out_i"])
def test_merge_rows_binding_refuses_unequal_row_strides(wide):
    """The kernel reads idx at vals' row stride and writes out_i at out_v's,
    so the binding refuses a pair whose row strides differ (a column slice
    of a wider arena) rather than read or write the wrong rows."""
    from repro_torch.kernels.list_merge.kernel import merge_rows_cuda

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    t = {"vals": meta((9, 13)), "idx": meta((9, 13), torch.int32),
         "out_v": meta((11, 17)), "out_i": meta((11, 17), torch.int32)}
    args = lambda: (t["vals"], t["idx"], meta((3, 9)),
                    meta((3,), torch.int32), slice(2, 7), t["out_v"],
                    t["out_i"])
    merge_rows_cuda(*args(), n_base=8)                # equal strides: fine
    shape = t[wide].shape
    t[wide] = meta((shape[0], shape[1] + 4), torch.int32)[:, :shape[1]]
    with pytest.raises(ValueError, match="row strides differ"):
        merge_rows_cuda(*args(), n_base=8)
