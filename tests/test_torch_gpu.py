"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same inputs, and the server on the card
against the server on the CPU.

This file imports neither ``jax`` nor ``repro`` (the card's machine has no
JAX), and every test is marked ``gpu`` and skips without a CUDA device.
Run it on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: ``similarity`` within 1e-5 (f32) and 2e-2 (bf16), the bounds
of ``tests/test_kernels.py``; ``knn_score`` and ``list_merge`` bit-for-bit
(same serial order; pure data movement).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.bridge import (lists_match, ranked_match, state_from_numpy,
                                state_to_numpy)
from repro_torch.core import knn, similarity
from repro_torch.kernels import launch_counts
from repro_torch.kernels.knn_score.ops import knn_scores
from repro_torch.kernels.knn_score.ref import knn_scores_ref
from repro_torch.kernels.list_merge.ops import merge_insert
from repro_torch.kernels.list_merge.ref import (merge_insert_ref,
                                                merge_sorted_ref)
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.serving import CFServer, ServerConfig, SnapshotConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ratings(rng, n, m, density=0.3):
    R = (rng.integers(1, 6, (n, m)) * (rng.random((n, m)) < density)
         ).astype(np.float32)
    R[R.sum(axis=1) == 0, 0] = 3.0
    return R


@pytest.mark.parametrize("nq,n,m", [(1, 70, 33), (37, 451, 300),
                                    (64, 1000, 1682), (130, 259, 515)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_similarity_kernel_matches_plain(cuda, nq, n, m, dtype):
    rng = np.random.default_rng(nq * 1000 + n)
    Q = torch.as_tensor(rng.normal(size=(nq, m)).astype(np.float32),
                        device=cuda).to(dtype)
    R = torch.as_tensor(rng.normal(size=(n, m)).astype(np.float32),
                        device=cuda).to(dtype)
    qn = torch.sqrt(torch.sum(torch.square(Q.float()), dim=1))
    rn = torch.sqrt(torch.sum(torch.square(R.float()), dim=1))
    before = launch_counts()["similarity"]
    out = cosine_similarity(Q, R, qn, rn)
    torch.cuda.synchronize()
    assert launch_counts()["similarity"] == before + 1
    ref = similarity_ref(Q, R, qn.clamp_min(1e-12), rn.clamp_min(1e-12))
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, atol=tol, rtol=0)


def test_similarity_kernel_exact_on_integer_ratings(cuda):
    """Integer star ratings make every dot product exact in fp32, so the
    kernel agrees with ``cosine_vs_all`` to the bit: a burst-onboarded list
    stays within the twin tolerance of later probes."""
    R = torch.as_tensor(_ratings(np.random.default_rng(0), 300, 97),
                        device=cuda)
    norms = similarity.row_norms(R)
    out = cosine_similarity(R[:5].clone(), R, norms[:5], norms)
    for q in range(5):
        assert torch.equal(out[q],
                           similarity.cosine_vs_all(R, norms, R[q]))


def _knn_case(rng, B, k, N, m):
    R = (rng.integers(1, 6, (N, m)) * (rng.random((N, m)) < 0.3)
         ).astype(np.float32)
    w = np.maximum(rng.normal(size=(B, k)), 0.0).astype(np.float32)
    nbrs = rng.integers(0, N, (B, k)).astype(np.int32)
    users = rng.integers(0, N, B).astype(np.int32)
    return R, w, nbrs, users


@pytest.mark.parametrize("B,k,N,m", [(1, 3, 10, 7), (33, 20, 120, 40),
                                     (256, 20, 2000, 1682),
                                     (5, 50, 300, 3001)])
def test_knn_score_kernel_bitwise_plain(cuda, B, k, N, m):
    case = [torch.as_tensor(x, device=cuda) for x in
            _knn_case(np.random.default_rng(B + k + m), B, k, N, m)]
    before = launch_counts()["knn_score"]
    out = knn_scores(*case)
    torch.cuda.synchronize()
    assert launch_counts()["knn_score"] == before + 1
    ref = knn_scores_ref(case[0], case[1], case[2].long(), case[3].long())
    assert torch.equal(out, ref)


def _merge_case(rng, R, L, k):
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
    return vals, idx, ins_vals, ins_idx, rng.random((R, k)) < 0.7


@pytest.mark.parametrize("R,L,k", [(5, 12, 3), (16, 64, 1), (3, 8, 8),
                                   (300, 1000, 64), (64, 4097, 200)])
def test_list_merge_kernel_bitwise_plain(cuda, R, L, k):
    args = [torch.as_tensor(x, device=cuda) for x in
            _merge_case(np.random.default_rng(R + L + k), R, L, k)]
    before = launch_counts()["list_merge"]
    kv, ki = merge_insert(*args)
    torch.cuda.synchronize()
    assert launch_counts()["list_merge"] == before + 1
    ov, oi = merge_insert_ref(*args)
    assert torch.equal(kv, ov) and torch.equal(ki, oi)
    sv, order = torch.sort(torch.where(args[4], args[2], -3.0), dim=1,
                           stable=True)
    rv, ri = merge_sorted_ref(args[0], args[1], sv,
                              torch.gather(args[3], 1, order))
    assert torch.equal(kv, rv) and torch.equal(ki, ri)


def test_server_on_card_matches_cpu(cuda):
    """The same request script on the card and on the CPU (plain
    versions): statuses and twin flags exact, lists within 1e-6, and the
    card's answers equal to the plain path's on the card's own state (two
    independently built arenas differ within 1e-6, which a weighted mean
    may amplify, so answers are compared on the same inputs)."""
    rng = np.random.default_rng(0)
    R = _ratings(rng, 120, 40)
    fresh = _ratings(np.random.default_rng(1), 6, 40)
    script = [R[3], R[3], fresh[0], R[10], fresh[0], *fresh[1:], R[20],
              R[3], fresh[2]]
    cfg = ServerConfig(capacity_extra=8, c_probes=4,
                       snapshot=SnapshotConfig(check_every=1))
    users = list(range(0, 130, 3))
    out = {}
    for dev in ("cuda", "cpu"):
        srv = CFServer(R, cfg, device=dev)
        res = [srv.onboard_user(r) for r in script]
        out[dev] = (res, srv.recommend_batch(users, n=5, k_neighbors=7),
                    srv.predict_batch(users, [5] * len(users), k=7),
                    state_to_numpy(srv.state), srv.stats)
    (rc, qc, pc, sc, tc), (rh, _, _, sh, th) = out["cuda"], out["cpu"]
    assert [(r.status, r.twin_found, r.user_id) for r in rc] == \
        [(r.status, r.twin_found, r.user_id) for r in rh]
    assert tc.rotations == th.rotations == 1
    assert lists_match(sh["sim_vals"], sh["sim_idx"], sc["sim_vals"],
                       sc["sim_idx"], 1e-6) is None

    plain = state_from_numpy(sc, "cpu")
    vals, items = knn.recommend_batch(plain, users, 7, 5)
    assert ranked_match(vals.numpy(), items.numpy(),
                        [[s for _, s in r] for r in qc],
                        [[i for i, _ in r] for r in qc], 1e-6) is None
    np.testing.assert_allclose(
        pc, knn.predict_batch(plain, users, [5] * len(users), 7).numpy(),
        atol=1e-6, rtol=0)
