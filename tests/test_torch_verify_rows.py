"""Port parity: the verification kernel's wrapper against the JAX
reference.

The same numpy inputs go to ``repro.kernels.verify_rows`` (its Pallas
kernel in interpret mode, the JAX wrapper's default) and to
``repro_torch.kernels.verify_rows`` on the CPU (the plain version).  The
flags must match exactly, in float32 and in int8.  The kernel itself is
held to its plain version on the card in ``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import verify_rows as jverify_rows
from repro.kernels.verify_rows.ref import verify_rows_ref as jref
from repro.distributed.replication import _row_ok as jrow_ok
from repro_torch.kernels import launch_counts, verify_rows
from repro_torch.kernels.verify_rows import kernel as vkernel
from repro_torch.kernels.verify_rows.ops import live_rows_ok

torch.set_num_threads(2)


def _assert_parity(C, r0, valid):
    before = launch_counts()["verify_rows"]
    out = verify_rows(torch.as_tensor(C), torch.as_tensor(r0),
                      torch.as_tensor(valid))
    assert launch_counts()["verify_rows"] == before    # plain version ran
    assert out.dtype == torch.bool and out.shape == (C.shape[0],)
    jout = jverify_rows(jnp.asarray(C), jnp.asarray(r0), jnp.asarray(valid))
    assert np.array_equal(out.numpy(), np.asarray(jout))
    rout = jref(jnp.asarray(C), jnp.asarray(r0), jnp.asarray(valid))[:, 0]
    assert np.array_equal(out.numpy(), np.asarray(rout))
    return out.numpy()


@pytest.mark.parametrize("s,m", [(8, 16), (37, 211), (256, 512), (300, 700)])
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_verify_rows_sweep_parity(s, m, dtype):
    """The shapes of ``tests/test_kernels.py``'s sweep, with a few planted
    copies of the target so that some flags are true."""
    rng = np.random.default_rng(s * m)
    C = rng.integers(0, 6, (s, m)).astype(dtype)
    C[rng.choice(s, size=min(3, s), replace=False)] = C[s // 2]
    valid = rng.random(s) < 0.8
    valid[s // 2] = True
    out = _assert_parity(C, C[s // 2].copy(), valid)
    assert out[s // 2]


def test_verify_rows_signed_zero_and_nan():
    """Values compare as values: -0.0 equals 0.0; NaN equals nothing, not
    even itself."""
    m = 97
    rng = np.random.default_rng(1)
    r0 = rng.integers(0, 6, m).astype(np.float32)
    r0[[3, 40]] = 0.0
    C = np.tile(r0, (6, 1))
    C[1, 3] = -0.0                                    # still a twin
    C[2, 10] = np.nan                                 # NaN in the row
    C[4, 96] = 7.0                                    # last column differs
    C[5, 0] = 1.0 + r0[0]                             # first column differs
    out = _assert_parity(C, r0, np.ones(6, bool))
    assert out.tolist() == [True, True, False, True, False, False]
    r0_nan = r0.copy()
    r0_nan[10] = np.nan                               # NaN == NaN is false
    out = _assert_parity(C, r0_nan, np.ones(6, bool))
    assert not out.any()


def test_verify_rows_all_invalid_block():
    rng = np.random.default_rng(2)
    C = np.tile(rng.integers(0, 6, 130).astype(np.int8), (40, 1))
    out = _assert_parity(C, C[0].copy(), np.zeros(40, bool))
    assert not out.any()


def test_verify_rows_promotes_like_jnp():
    """int8 candidates against a float32 target compare in float32, as
    jnp's == promotes them."""
    rng = np.random.default_rng(3)
    C = rng.integers(0, 6, (20, 75)).astype(np.int8)
    r0 = C[4].astype(np.float32)
    r0_off = r0.copy()
    r0_off[9] += 0.5
    assert _assert_parity(C, r0, np.ones(20, bool))[4]
    assert not _assert_parity(C, r0_off, np.ones(20, bool)).any()


@pytest.mark.parametrize("poison", ["none", "nan_list", "inf_rating",
                                    "unsorted", "neg_norm", "dead_row_nan"])
@pytest.mark.parametrize("n_active", [0, 9, 23, 30])
def test_arena_healthy_sliced_matches_reference(monkeypatch, poison,
                                                n_active):
    """The port sweeps the arena in slices of live rows; the verdict equals
    the reference's whole-arena ``arena_healthy`` for every slicing."""
    from repro.kernels.verify_rows.ops import arena_healthy as jhealthy
    from repro_torch.kernels.verify_rows import ops
    rng = np.random.default_rng(3)
    R = 24
    sv = np.sort(rng.normal(size=(R, R)), axis=1).astype(np.float32)
    rt = rng.integers(0, 6, (R, 7)).astype(np.float32)
    nm = rng.random(R).astype(np.float32)
    row = min(max(n_active - 1, 0), R - 1)
    if poison == "nan_list":
        sv[row, 3] = np.nan
    elif poison == "inf_rating":
        rt[row, 2] = np.inf
    elif poison == "unsorted":
        sv[row] = sv[row, ::-1]
    elif poison == "neg_norm":
        nm[row] = -1.0
    elif poison == "dead_row_nan":
        sv[R - 1], rt[R - 1] = np.nan, np.nan     # past n_active < R
    want = bool(jhealthy(jnp.asarray(sv), jnp.asarray(rt), jnp.asarray(nm),
                         jnp.int32(n_active)))
    for chunk in (1, 5, 4096):
        monkeypatch.setattr(ops, "HEALTH_CHUNK_ROWS", chunk)
        got = ops.arena_healthy(torch.as_tensor(sv), torch.as_tensor(rt),
                                torch.as_tensor(nm), n_active)
        assert bool(got) == want, (poison, n_active, chunk)


def test_live_cost_at_douban_shape():
    """The sweep's bound at the Douban-width arena: 4 bytes a list value, a
    rating and a norm read, 1 byte a flag written, each once."""
    n, L, m = 32_832, 32_832, 58_541
    c = vkernel.live_cost(n, L, m)
    assert c.bytes == n * (4 * L + 4 * m + 4 + 1) == 11_999_997_504
    assert c.flops == n * (L + m + 1)
    assert c.bytes / 3.35e12 * 1e3 == pytest.approx(3.582, abs=5e-4)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["dtype", "rows", "norms", "stride",
                                  "device"])
def test_live_rows_wrapper_refuses(case):
    """What the kernel does not take raises before any launch (meta tensors
    stand for the card's)."""
    sv, rt, nm = _meta(6, 6), _meta(6, 11), _meta(6)
    err, args = {
        "dtype": (TypeError, (sv, rt.double(), nm)),
        "rows": (ValueError, (sv[:5], rt, nm)),
        "norms": (ValueError, (sv, rt, _meta(5))),
        "stride": (ValueError, (sv, _meta(11, 6).t(), nm)),
        "device": (ValueError, (sv, rt, torch.zeros(6)))}[case]
    before = launch_counts()["verify_rows"]
    with pytest.raises(err):
        vkernel.live_rows_cuda(*args, 6)
    assert launch_counts()["verify_rows"] == before


def _rule_cases(rng, n=20, L=13, m=9):
    """An arena with one fault or sound special case a row: NaN/inf in a
    list or a rating, a descending pair, a descending subnormal pair,
    ascending subnormals beside -0.0 and 0.0, equal values, a SENTINEL row,
    norms NaN, -1, -0.0 and minus the least subnormal."""
    sv = np.sort(np.round(rng.uniform(-1, 1, (n, L)), 1), axis=1)
    sv[:, 0], sv[:, -1] = -2.0, 1.0           # a drop at each row boundary
    rt = rng.integers(0, 6, (n, m)).astype(np.float64)
    nm = np.sqrt((rt ** 2).sum(axis=1))
    sv, rt, nm = (a.astype(np.float32) for a in (sv, rt, nm))
    tiny = np.array([1, 2, 3, 5], dtype=np.uint32).view(np.float32)
    sv[0, 5], sv[1, -1], rt[2, 0], rt[3, -1] = np.nan, np.inf, -np.inf, np.nan
    sv[4, 6] = sv[4, 5] - 0.5
    sv[5], sv[5, :4], sv[5, -4:] = 0.0, [-0.0, 0.0, 0.0, -0.0], tiny
    sv[6], sv[6, -4:] = 0.0, tiny[::-1]
    sv[7], sv[8] = 0.25, -2.0
    nm[9], nm[10], nm[11], nm[12] = np.nan, -1.0, -0.0, -tiny[0]
    return sv, rt, nm


@pytest.mark.parametrize("n_active", [0, 7, 20, 25])
def test_live_rows_ok_plain_on_cpu_is_the_rule(n_active):
    """On the CPU ``live_rows_ok`` is the plain version (nothing launches)
    and equals the reference's per-row rule, over the live rows only."""
    sv, rt, nm = _rule_cases(np.random.default_rng(n_active))
    sv[18:], rt[18:] = np.nan, np.nan         # past n_active = 7
    live = min(n_active, 20)
    before = launch_counts()["verify_rows"]
    got = live_rows_ok(torch.as_tensor(sv), torch.as_tensor(rt),
                       torch.as_tensor(nm), n_active)
    assert launch_counts()["verify_rows"] == before
    want = jrow_ok(rt[:live], nm[:live], sv[:live])
    np.testing.assert_array_equal(got.numpy(), want)
    if live == 20:
        assert [i for i in range(18) if not want[i]] == [
            0, 1, 2, 3, 4, 6, 9, 10, 12]
