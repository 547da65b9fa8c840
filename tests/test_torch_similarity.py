"""Port parity: ``repro_torch`` similarity measures, the similarity kernel's
wrapper and the traditional burst against the JAX reference.

Tolerances: similarity values agree within 1e-6 (``cosine_matrix`` in
float32 and in bfloat16 ``compute_dtype`` too: both round the same rows;
1e-5 for the kernel-shaped (nq, m) x (m, n) products of random normals, 2e-2 for bf16 —
the bounds ``tests/test_kernels.py`` holds the Pallas kernel to).  Sorted
lists match under ``bridge.lists_match``: ids exact except inside runs of
values within the tolerance.  The kernel itself is held to its plain
version on the card in ``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import baseline as jbase
from repro.core import build_state as jbuild
from repro.core import similarity as jsim
from repro.kernels.similarity.ops import cosine_similarity as jcos
from repro.kernels.similarity.ref import similarity_ref as jref
from repro_torch.bridge import state_from_numpy, state_to_numpy, lists_match
from repro_torch.core import baseline, similarity
from repro_torch.kernels import launch_counts
from repro_torch.kernels.similarity.ops import cosine_similarity
from tests.conftest import make_ratings

torch.set_num_threads(2)

SIM_TOL = 1e-6
KERNEL_TOL = {np.float32: 1e-5, "bf16": 2e-2}


def _jstate_np(js) -> dict:
    return {k: np.asarray(getattr(js, k)) for k in
            ("ratings", "norms", "sim_vals", "sim_idx", "n_active")}


@pytest.mark.parametrize("measure", ["cosine", "pearson", "adjusted_cosine"])
def test_similarity_matrix_parity(rng, measure):
    R = make_ratings(rng)
    ref = np.asarray(jsim.similarity_matrix(jnp.asarray(R), measure))
    out = similarity.similarity_matrix(torch.as_tensor(R), measure).numpy()
    np.testing.assert_allclose(out, ref, atol=SIM_TOL, rtol=0)


def test_row_norms_and_cosine_vs_all_parity(rng):
    R = make_ratings(rng)
    r0 = make_ratings(np.random.default_rng(5), n=1)[0]
    jn = np.asarray(jsim.row_norms(jnp.asarray(R)))
    tn = similarity.row_norms(torch.as_tensor(R)).numpy()
    np.testing.assert_array_equal(tn, jn)
    ref = np.asarray(jsim.cosine_vs_all(jnp.asarray(R), jnp.asarray(jn),
                                        jnp.asarray(r0)))
    out = similarity.cosine_vs_all(torch.as_tensor(R), torch.as_tensor(tn),
                                   torch.as_tensor(r0)).numpy()
    np.testing.assert_allclose(out, ref, atol=SIM_TOL, rtol=0)


def _normal_case(nq, n, m):
    rng = np.random.default_rng(nq * 1000 + n)
    return (rng.normal(size=(nq, m)).astype(np.float32),
            rng.normal(size=(n, m)).astype(np.float32))


@pytest.mark.parametrize("nq,n,m", [(8, 16, 32), (37, 451, 300),
                                    (130, 259, 515)])
@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_cosine_similarity_parity(nq, n, m, dtype):
    """The port's wrapper on CPU (its plain version) against the Pallas
    kernel in interpret mode and against the JAX ``ref.py``."""
    Q, R = _normal_case(nq, n, m)
    jQ, jR = jnp.asarray(Q), jnp.asarray(R)
    tQ, tR = torch.as_tensor(Q), torch.as_tensor(R)
    if dtype == "bf16":
        jQ, jR = jQ.astype(jnp.bfloat16), jR.astype(jnp.bfloat16)
        tQ, tR = tQ.bfloat16(), tR.bfloat16()
    before = launch_counts()["similarity"]
    out = cosine_similarity(tQ, tR).numpy()
    assert launch_counts()["similarity"] == before     # plain version ran
    tol = KERNEL_TOL[dtype]
    np.testing.assert_allclose(out, np.asarray(jcos(jQ, jR)), atol=tol)
    qn = jnp.linalg.norm(jQ.astype(jnp.float32), axis=1)
    rn = jnp.linalg.norm(jR.astype(jnp.float32), axis=1)
    np.testing.assert_allclose(out, np.asarray(jref(jQ, jR, qn, rn)),
                               atol=tol)


def test_onboard_batch_traditional_parity(rng):
    """The fused burst (plain similarity on CPU) against the JAX fused burst
    (Pallas in interpret mode) and against the port's own unfused loop."""
    R = make_ratings(rng)
    burst = np.concatenate([R[3:5], make_ratings(
        np.random.default_rng(9), n=4)])
    js = jbuild(jnp.asarray(R), capacity_extra=8)
    j_out = _jstate_np(jbase.onboard_batch_traditional(
        js, jnp.asarray(burst), fused=True, interpret=True))
    fused = state_to_numpy(baseline.onboard_batch_traditional(
        state_from_numpy(_jstate_np(js), device="cpu"),
        torch.as_tensor(burst)))
    loop = state_to_numpy(baseline.onboard_batch_traditional(
        state_from_numpy(_jstate_np(js), device="cpu"),
        torch.as_tensor(burst), fused=False))
    for out in (fused, loop):
        assert out["n_active"] == j_out["n_active"] == 126
        np.testing.assert_array_equal(out["ratings"], j_out["ratings"])
        np.testing.assert_array_equal(out["norms"], j_out["norms"])
        assert lists_match(j_out["sim_vals"], j_out["sim_idx"],
                           out["sim_vals"], out["sim_idx"], SIM_TOL) is None


def test_burst_must_fit_free_slots(rng):
    R = make_ratings(rng, n=20, m=8)
    js = jbuild(jnp.asarray(R), capacity_extra=2)
    st = state_from_numpy(_jstate_np(js), device="cpu")
    with pytest.raises(ValueError, match="arena full"):
        baseline.onboard_batch_traditional(st, torch.as_tensor(R[:3]))



@pytest.mark.parametrize("nq,bm", [(1, 32), (31, 32), (32, 32), (33, 64),
                                   (64, 64), (65, 64), (130, 64)])
@pytest.mark.parametrize("dtype,tag", [(torch.float32, "f32"),
                                       (torch.bfloat16, "bf16")])
def test_similarity_variant_by_nq(monkeypatch, nq, bm, dtype, tag):
    """f32: the wrapper picks the 32-row tile up to the server's burst of
    32 and the 64-row tile above it.  bf16: one entry point for every nq,
    the tensor cores' ``cosine_similarity_bf16_wgmma``.  Both pass Q, R,
    the norms and the output as pointers, then nq, n and m as ints (bf16:
    and the row strides of Q and R) and the stream last (checked through a
    fake library)."""
    import ctypes
    import types

    from repro_torch.kernels import _lib
    from repro_torch.kernels.similarity import kernel as skernel

    calls = []

    def entry(name):
        def call(*cargs):
            calls.append((name, cargs))
            return 0
        return call

    names = ["cosine_similarity_f32_bm32", "cosine_similarity_f32_bm64",
             "cosine_similarity_bf16_wgmma"]
    fake = _lib.Kernel("similarity")
    monkeypatch.setattr(fake, "load", lambda: types.SimpleNamespace(
        **{name: entry(name) for name in names}))
    monkeypatch.setattr(skernel, "SIMILARITY", fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    n, m = 300, 77
    Q = skernel.row_buffer(nq, m, dtype, "cpu").zero_()
    R = skernel.row_buffer(n, m, dtype, "cpu").zero_()
    qn, rn, out = torch.ones(nq), torch.ones(n), torch.empty((nq, n))
    assert skernel.block_rows(nq) == bm
    want = ("cosine_similarity_bf16_wgmma" if dtype == torch.bfloat16
            else f"cosine_similarity_{tag}_bm{bm}")
    assert skernel.entry_point(dtype, nq) == want
    skernel.launch_similarity(Q, R, qn, rn, out)
    (name, cargs), = calls
    assert name == want
    p, i = ctypes.c_void_p, ctypes.c_int
    ints = [nq, n, m] + ([80, 80] if dtype == torch.bfloat16 else [])
    assert [type(c) for c in cargs] == [p] * 5 + [i] * len(ints) + [p]
    assert [c.value for c in cargs[:5]] == [t.data_ptr()
                                            for t in (Q, R, qn, rn, out)]
    assert [c.value for c in cargs[5:-1]] == ints
    assert fake.launches == 1


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _unit_norms(*ns):
    return [torch.ones(k, device="meta") for k in ns]


@pytest.mark.parametrize("case", ["stride77", "base_off16", "items_strided"])
def test_similarity_cuda_refuses_unaligned_bf16_rows(case):
    """TMA reads rows whose base and row stride are multiples of 16 bytes:
    a bf16 row stride of 77 items, a base 2 bytes past the buffer's (a
    column offset), or items not adjacent raise, with no fallback."""
    from repro_torch.kernels.similarity.kernel import similarity_cuda
    good = _meta((6, 80))[:, :77]
    bad = {"stride77": _meta((6, 77)),
           "base_off16": _meta((6, 80))[:, 1:78],
           "items_strided": _meta((6, 154))[:, ::2]}[case]
    with pytest.raises(ValueError, match="row stride"):
        similarity_cuda(bad, good, *_unit_norms(6, 6))
    with pytest.raises(ValueError, match="row stride"):
        similarity_cuda(good, bad, *_unit_norms(6, 6))


@pytest.mark.parametrize("n,m", [(7, 77), (300, 515), (33, 8)])
def test_similarity_cuda_takes_aligned_views_and_counts_logical_m(n, m):
    """The ``[:, :m]`` view of an (n, roundup(m, 8)) buffer goes to the
    kernel as it lies, and its cost counts the logical m, not the stride."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.similarity import kernel as skernel
    from repro_torch.launch.trace import Counter
    R = skernel.row_buffer(n, m, torch.bfloat16, "meta")
    assert R.shape == (n, m) and R.stride() == (-(-m // 8) * 8, 1)
    Q = R[n // 2:]
    before = _lib.SIMILARITY.launches
    with Counter() as counter:
        out = skernel.similarity_cuda(Q, R, *_unit_norms(Q.shape[0], n))
    assert out.shape == (Q.shape[0], n) and out.dtype == torch.float32
    cost = skernel.cost(Q.shape[0], n, m, torch.bfloat16)
    assert counter.kernels["similarity"] == {
        "calls": 1, "flops": cost.flops, "bytes": cost.bytes}
    assert _lib.SIMILARITY.launches == before


@pytest.mark.parametrize("m", [1, 8, 77, 515])
def test_row_buffer_pads_with_zeros(m):
    """A bf16 ``row_buffer`` is the ``[:, :m]`` view of a buffer whose pad
    columns are zero, so the whole buffer's row products equal the view's."""
    from repro_torch.kernels.similarity import kernel as skernel
    R = skernel.row_buffer(9, m, torch.bfloat16, "cpu")
    R.copy_(torch.randint(0, 6, (9, m), generator=torch.Generator()
                          .manual_seed(m)))
    ld = R.stride(0)
    assert ld % 8 == 0 and 0 <= ld - m < 8
    full = R.as_strided((9, ld), (ld, 1))
    assert torch.equal(full[:, :m], R)
    assert not full[:, m:].any()
    assert torch.equal(full.float() @ full.float().T, R.float() @ R.float().T)


@pytest.mark.parametrize("q_off", [0, 1])
def test_cosine_similarity_copies_unaligned_bf16_rows(q_off):
    """``ops.cosine_similarity`` takes bf16 rows of any stride: unaligned
    ones are copied to an aligned buffer, then the kernel (here its
    ``meta`` branch) runs on the copy with the logical m."""
    from repro_torch.kernels.similarity import kernel as skernel
    from repro_torch.launch.trace import Counter
    Q = _meta((5, 40))[:, q_off:q_off + 33]
    R = _meta((70, 33))
    assert not skernel.rows_aligned(R)
    with Counter() as counter:
        out = cosine_similarity(Q, R)
    assert out.shape == (5, 70) and out.is_meta
    cost = skernel.cost(5, 70, 33, torch.bfloat16)
    assert counter.kernels["similarity"]["flops"] == cost.flops


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cosine_matrix_compute_dtype_parity(rng, dtype):
    """``compute_dtype``: the rows and their norms rounded to it and
    divided there, the products summed in float32, as in the reference."""
    R = make_ratings(rng)
    ref = np.asarray(jsim.cosine_matrix(jnp.asarray(R),
                                        compute_dtype=getattr(jnp, dtype)))
    out = similarity.cosine_matrix(torch.as_tensor(R),
                                   compute_dtype=getattr(torch, dtype))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=SIM_TOL, rtol=0)
    if dtype == "bfloat16":
        f32 = similarity.cosine_matrix(torch.as_tensor(R)).numpy()
        assert np.abs(out.numpy() - f32).max() > SIM_TOL   # it did round
