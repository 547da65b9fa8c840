"""Card-only tests of the port: each hand-written CUDA kernel against its
plain PyTorch version on the same inputs, and the server on the card
against the server on the CPU.

This file imports neither ``jax`` nor ``repro`` (the card's machine has no
JAX), and every test is marked ``gpu`` and skips without a CUDA device.
Run it on the card with ``python -m pytest -m gpu tests/test_torch_gpu.py``.

Tolerances: ``similarity`` within 1e-5 (f32, the bound of
``tests/test_kernels.py``; bf16, whose products are exact in fp32 and whose
outputs are cosines, at most 1 in magnitude: only the order of the fp32
sums differs), bit for bit on integer ratings in both dtypes; ``knn_score``, ``embedding_bag`` and
``list_merge`` bit-for-bit (same serial order; pure data movement);
``twin_probe`` and ``verify_rows`` exactly (masks, counts and flags);
``key_dedup`` exactly (hashes bit for bit, answers, and the plan equal to
``dedup_rows``' over the same keys on the host, forced collisions
included).  The
write path: ``RotationPlan.finalize`` bit-identical to
``rotate_arena_frozen`` on the card; ``add_rating`` on the card
bit-identical to the CPU plain path (integer ratings: every dot is an exact
integer); a checkpoint from the card restores every leaf exactly; a crashed
and recovered server on the card bit-identical to the uncrashed one.
Replication and the buffered burst: a replica ``repair`` of card tensors
bit-identical to the state before the poison (and a refused one leaves it
untouched); the chunked base merge bit-identical to the unchunked one and
to the CPU's plain version; ``onboard_batch_buffered`` on the card against
the plain path on the CPU, flags exact, lists within 1e-6.  The CF family
and the sharded burst, on a one-rank NCCL process group: the sharded burst
on the card against the buffered burst's plain path on the CPU (flags
exact, lists within 1e-6) and the card's buffered burst (bit for bit), its
collective bytes equal to ``payload_bytes``, the resilient burst healing a
NaN row bit for bit; ``build_step`` on the similarity kernel against its
plain path within 1e-5; ``twins_graph`` and ``gaussian`` on card tensors
equal to the CPU's.  The GNN family at small sizes, card against the CPU
plain path (``chip_smoke.py``'s bounds): layer outputs within 1e-5 of the
largest |host value|, losses within 1e-5 relative, each gradient leaf
within 1e-4 of its largest |host value| (``index_add_`` adds with atomics
in no fixed order on the card); the edge-parallel GAT on a one-rank NCCL
group, in chunks that do not divide the edge count, against
``gnn.loss_full`` on the CPU.  Expert parallelism on a one-rank NCCL group
(a (1, 1) mesh): ``moe_ffn_ep`` against ``moe_ffn`` on the card where
nothing drops, and a tiny OLMoE prefill cell through ``build_cell`` against
the plain prefill on the CPU (the LM bounds, ``_lm_close``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.bridge import (lists_match, ranked_match, state_from_numpy,
                                state_to_numpy)
from repro_torch.core import knn, similarity
from repro_torch.kernels import (embedding_bag, launch_counts, twin_probe,
                                 verify_rows)
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.kernels.key_dedup import ops as key_dedup
from repro_torch.kernels.key_dedup.kernel import verify_cuda
from repro_torch.kernels.key_dedup.ref import key_words, probe_ref, verify_ref
from repro_torch.kernels.knn_score.ops import knn_scores
from repro_torch.kernels.knn_score.ref import knn_scores_ref
from repro_torch.kernels.list_merge.ops import merge_insert, merge_rows
from repro_torch.kernels.list_merge.ref import (merge_insert_ref,
                                                merge_rows_ref,
                                                merge_sorted_ref)
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.kernels.similarity.ref import similarity_ref
from repro_torch.kernels.twin_probe.ref import twin_probe_ref
from repro_torch.kernels.verify_rows.ops import arena_healthy, live_rows_ok
from repro_torch.kernels.verify_rows.ref import (live_rows_ok_ref,
                                                 verify_rows_ref)
from repro_torch.core import (RotationPlan, build_state, maintenance,
                              onboard_batch_buffered, rotate_arena_frozen,
                              set0_cap, update)
from repro_torch.core.types import SENTINEL
from repro_torch.distributed import ReplicatedArena, ReplicationConfig
from repro_torch.serving import (CFServer, RotationConfig, ServerConfig,
                                 SnapshotConfig, WalConfig)
from repro_torch.serving.cf_server import plan_of_first
from repro_torch.serving.dedup import dedup_rows
from repro_torch.testing import (SimulatedCrash, forbid_similarity_kernels,
                                 install_crash, kill_replica)
from repro_torch.training import checkpoint

torch.set_num_threads(2)

pytestmark = pytest.mark.gpu

# similarity: f32, and bf16 (unit-norm rows, or any rows divided by their
# norms in the epilogue).
SIM_TOL = 1e-5


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
    torch.testing.assert_close(out, ref, atol=SIM_TOL, rtol=0)


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


@pytest.mark.parametrize("nq", [1, 31, 32, 33, 63, 64, 65, 129, 130, 257])
@pytest.mark.parametrize("m", [7, 100, 515])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_similarity_kernel_variants_and_edges(cuda, nq, m, dtype):
    """f32: both tile variants (32 rows of Q up to nq = 32, 64 above) at
    their edges; m = 7 is below one 32-item slice, 100 is not a multiple of
    it, 515 is odd (rows off 16-byte alignment).  bf16 (the wgmma entry
    point, 128-row tiles of two 64-row warpgroups): nq <= 64 leaves the
    second warpgroup idle, 129 and 257 start a ragged tile row; m = 7 ends
    within one 64-item step, 100 and 515 across steps, and their rows are
    copied to an aligned stride first.  n = 300 is not a multiple of
    either route's tile."""
    n = 300
    rng = np.random.default_rng(nq * 100 + m)
    Q = torch.as_tensor(rng.normal(size=(nq, m)).astype(np.float32),
                        device=cuda).to(dtype)
    R = torch.as_tensor(rng.normal(size=(n, m)).astype(np.float32),
                        device=cuda).to(dtype)
    qn = torch.sqrt(torch.sum(torch.square(Q.float()), dim=1))
    rn = torch.sqrt(torch.sum(torch.square(R.float()), dim=1))
    out = _launched("similarity", cosine_similarity, Q, R, qn, rn)
    ref = similarity_ref(Q, R, qn.clamp_min(1e-12), rn.clamp_min(1e-12))
    torch.testing.assert_close(out, ref, atol=SIM_TOL, rtol=0)


@pytest.mark.parametrize("nq", [32, 64])
def test_similarity_kernel_exact_on_integer_ratings_per_variant(cuda, nq):
    """Integer ratings at each tile variant's full width (nq = 32: the
    32-row tile; nq = 64: the 64-row tile), m = 1,001 (odd, not a multiple
    of the slice): bit-identical to the plain version and to
    ``cosine_vs_all`` row by row."""
    R = torch.as_tensor(_ratings(np.random.default_rng(nq), 700, 1001),
                        device=cuda)
    Q = torch.as_tensor(_ratings(np.random.default_rng(nq + 1), nq, 1001),
                        device=cuda)
    rn, qn = similarity.row_norms(R), similarity.row_norms(Q)
    out = _launched("similarity", cosine_similarity, Q, R, qn, rn)
    assert torch.equal(out, similarity_ref(Q, R, qn.clamp_min(1e-12),
                                           rn.clamp_min(1e-12)))
    for q in range(nq):
        assert torch.equal(out[q], similarity.cosine_vs_all(R, rn, Q[q]))


@pytest.mark.parametrize("nq", [1, 32, 64, 129])
def test_similarity_bf16_exact_on_integer_ratings(cuda, nq):
    """Integer ratings in bf16 (0-5 are exact there): every product and
    partial sum is an integer below 2^24, so the tensor cores' sums equal
    the plain version's bit for bit, the epilogue's rounding included
    (m = 1,001: rows copied to an aligned stride, a ragged last step)."""
    R = torch.as_tensor(_ratings(np.random.default_rng(nq), 700, 1001),
                        device=cuda).bfloat16()
    Q = torch.as_tensor(_ratings(np.random.default_rng(nq + 1), nq, 1001),
                        device=cuda).bfloat16()
    rn, qn = similarity.row_norms(R.float()), similarity.row_norms(Q.float())
    out = _launched("similarity", cosine_similarity, Q, R, qn, rn)
    assert torch.equal(out, similarity_ref(Q, R, qn.clamp_min(1e-12),
                                           rn.clamp_min(1e-12)))


def test_similarity_bf16_unit_rows_and_strided_views(cuda):
    """Unit-norm bf16 rows, as ``models/cf.build_step`` gives them, within
    1e-5; taken by ``similarity_cuda`` as views with a row stride above m
    (ld = 520 > m = 515) and a row offset, with no copy; an unaligned
    stride raises there."""
    from repro_torch.kernels.similarity.kernel import similarity_cuda
    rng = np.random.default_rng(3)
    n, m, ld = 300, 515, 520
    x = rng.normal(size=(n + 5, m)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    buf = torch.zeros((n + 5, ld), device=cuda, dtype=torch.bfloat16)
    buf[:, :m] = torch.as_tensor(x, device=cuda)
    R, Q = buf[:n, :m], buf[n - 130:, :m]
    ones_q = torch.ones(Q.shape[0], device=cuda)
    ones_n = torch.ones(n, device=cuda)
    out = _launched("similarity", similarity_cuda, Q, R, ones_q, ones_n)
    ref = similarity_ref(Q, R, ones_q, ones_n)
    torch.testing.assert_close(out, ref, atol=SIM_TOL, rtol=0)
    with pytest.raises(ValueError, match="row stride"):
        similarity_cuda(Q, R.contiguous(), ones_q, ones_n)


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


def _rows_case(rng, b, L, k, n_base):
    """b ascending rows over SENTINEL heads (a few values below SENTINEL,
    ties everywhere), ids a permutation of the columns with -1 at half the
    SENTINEL slots; rows 1, 4, ... keep every id at or above ``n_base`` on
    SENTINEL entries (onboarding's rows), the others hold gated real values
    in their middle.  Inserts tie with row entries, with each other and
    with SENTINEL; no -0.0 (torch.sort on the card orders it before 0.0,
    the CPU's and the kernel's stable order by value do not)."""
    pool = np.concatenate([[-2.5, -2.0, -2.0, -2.0],
                           np.round(rng.uniform(-1, 1, 6), 2) + 0.0])
    vals = np.sort(rng.choice(pool, size=(b, L)).astype(np.float32), axis=1)
    idx = np.stack([rng.permutation(L).astype(np.int32) for _ in range(b)])
    idx[(vals == -2.0) & (rng.random((b, L)) < 0.5)] = -1
    if n_base:
        keep = (np.arange(b) % 3 == 1)[:, None] & (vals != -2.0)
        idx[keep & (idx >= n_base)] %= n_base
    ins = (np.round(rng.uniform(-2.2, 1, (b, k)), 2) + 0.0).astype(
        np.float32)
    ins[rng.random((b, k)) < 0.2] = -2.0
    ins[0, 0] = vals[0, L // 2]
    if k > 1:
        ins[:, 1] = ins[:, 0]
    return vals, idx, ins


@pytest.mark.parametrize("b,L,k,fit", [(7, 97, 1, 5), (7, 97, 64, 0),
                                       (7, 97, 333, -3), (33, 1024, 64, 0),
                                       (5, 4097, 200, 7)])
@pytest.mark.parametrize("n_base", ["zero", "middle", "L"])
def test_merge_rows_kernel_bitwise_plain(cuda, b, L, k, fit, n_base):
    """The rotation's merge on the card: bit for bit its plain version on
    the CPU, one launch a call, rows written in place of an arena's rows
    (a slice and a list) and nothing else, the reordered rows counted."""
    n_base = {"zero": 0, "middle": 2 * L // 3, "L": L}[n_base]
    W = L + k + fit
    vals, idx, ins = map(torch.as_tensor, _rows_case(
        np.random.default_rng(b + L + k + n_base), b, L, k, n_base))
    ids = torch.arange(900, 900 + k, dtype=torch.int32)
    ev, ei, moved = merge_rows_ref(vals, idx, ins, ids, n_base=n_base,
                                   width=W)
    N = b + 2                                   # rows 0 and N - 1 not merged
    pad = torch.zeros(1, L)
    arena_v = torch.cat([pad, vals, pad]).to(cuda)
    arena_i = torch.cat([pad.int(), idx, pad.int()]).to(cuda)
    U = torch.cat([torch.zeros(k, 1), ins.T, torch.zeros(k, 1)],
                  dim=1).to(cuda)
    for rows in (slice(1, N - 1), list(range(N - 2, 0, -1))):
        out_v = torch.full((N, W), 7.0, device=cuda)
        out_i = torch.full((N, W), 7, dtype=torch.int32, device=cuda)
        count = torch.zeros(1, dtype=torch.int32, device=cuda)
        _launched("list_merge", merge_rows, arena_v, arena_i, U,
                  ids.to(cuda), rows, out_v, out_i, n_base=n_base,
                  reordered=count)
        assert torch.equal(out_v[1:-1].cpu(), ev)
        assert torch.equal(out_i[1:-1].cpu(), ei)
        assert (out_v[[0, -1]] == 7.0).all() and (out_i[[0, -1]] == 7).all()
        assert int(count) == int(moved.sum())


def test_merge_rows_kernel_at_douban_chunk_width(cuda):
    """One rotation chunk at Douban width: 4,096 base rows of 32,832 (each
    with the 64 write-region ids on its SENTINEL head, as onboarding leaves
    it), k = 64, into 32,896 columns; every 7th row with write-region ids
    planted on real values.  Bit for bit the plain version (run on the card
    in slices), and the planted rows counted."""
    b, k, n_base = 4096, 64, 32_768
    L, W = n_base + k, n_base + 2 * k
    g = torch.Generator(device=cuda).manual_seed(30)
    n_sent = 64 + torch.randint(0, 200, (b, 1), device=cuda, generator=g)
    vals = torch.round(torch.rand((b, L), device=cuda, generator=g) * 200
                       - 100) / 100 + 0.0
    vals = torch.sort(vals, dim=1).values
    col = torch.arange(L, device=cuda)
    vals[col[None, :] < n_sent] = SENTINEL
    base_ids = torch.argsort(torch.rand((b, n_base), device=cuda,
                                        generator=g), dim=1).int()
    idx = torch.cat([n_base + col[None, :k].int().expand(b, k), base_ids],
                    dim=1)
    planted = torch.arange(0, b, 7, device=cuda)
    swap = L // 2 + torch.arange(k, device=cuda)
    idx[planted[:, None], swap[None, :]], idx[planted, :k] = \
        idx[planted, :k], idx[planted[:, None], swap[None, :]]
    U = torch.round(torch.rand((k, b), device=cuda, generator=g) * 300
                    - 200) / 100 + 0.0
    U[U < -1] = SENTINEL
    U[3] = vals[:, L // 2]                      # ties with row entries
    ids = n_base + torch.arange(k, dtype=torch.int32, device=cuda)
    out_v = torch.empty((b, W), device=cuda)
    out_i = torch.empty((b, W), dtype=torch.int32, device=cuda)
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    _launched("list_merge", merge_rows, vals, idx, U, ids, slice(0, b),
              out_v, out_i, n_base=n_base, reordered=count)
    assert int(count) == len(planted)
    for r0 in range(0, b, 512):
        sl = slice(r0, r0 + 512)
        pv, pi, moved = merge_rows_ref(vals[sl], idx[sl], U[:, sl].T, ids,
                                       n_base=n_base, width=W)
        assert torch.equal(out_v[sl], pv) and torch.equal(out_i[sl], pi)
        assert torch.equal(moved.nonzero()[:, 0] + r0,
                           planted[(planted >= r0) & (planted < r0 + 512)])


def test_rotation_on_card_is_one_launch_a_chunk(cuda, monkeypatch):
    """A card rotation with a base row refreshed by ``add_rating`` (real
    values at write-region ids): one list_merge launch a chunk of base
    rows, bit for bit the CPU's rotation, the same reordered rows."""
    from repro_torch.core import rotation
    rng = np.random.default_rng(11)
    _, srv = _card_state(cuda, rng)
    n_base, st = srv.n_base, srv.state
    st, _ = update.add_rating(st, update.init_cache(st.ratings), 5, 3, 2.0)
    monkeypatch.setattr(rotation, "SORT_CHUNK_ROWS", 37)
    count = torch.zeros(1, dtype=torch.int32, device=cuda)
    before = launch_counts()["list_merge"]
    out = rotate_arena_frozen(st, n_base=n_base, n_frozen=st.n_active,
                              extra=9, reordered=count)
    torch.cuda.synchronize()
    assert launch_counts()["list_merge"] == before + -(-n_base // 37)
    host_count = torch.zeros(1, dtype=torch.int32)
    host = state_to_numpy(rotate_arena_frozen(
        state_from_numpy(state_to_numpy(st), "cpu"), n_base=n_base,
        n_frozen=st.n_active, extra=9, reordered=host_count))
    out = state_to_numpy(out)
    for key in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        np.testing.assert_array_equal(out[key], host[key], err_msg=key)
    assert int(count) == int(host_count) == 1


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


# ---------------------------------------------------------------------------
# key_dedup: the read path's twin dedup on the card, held to its plain
# version (hashes bit for bit, answers exactly) and to ``dedup_rows``' plan
# over the same keys on the host
# ---------------------------------------------------------------------------

def dedup_case(rng, B, k, N, m):
    """(sims (B, k) f32, nbrs (B, k) int32, R (N, m) f32, users (B,) int64)
    with twins planted: users 0 and 1 share a key; 2 differs from 0 only in
    its rating row's last word (the key's last word), 3 only in the last
    sim; users repeat (drawn from the first 12, 0-3 at least once each
    when B >= 4)."""
    S = rng.integers(0, 4, (N, k)).astype(np.float32) / 4
    I = rng.integers(0, N, (N, k)).astype(np.int32)
    R = (rng.integers(1, 6, (N, m)) * (rng.random((N, m)) < 0.05)
         ).astype(np.float32)
    S[1], I[1], R[1] = S[0], I[0], R[0]
    S[2], I[2], R[2] = S[0], I[0], R[0]
    R[2, -1] = R[0, -1] + 1.0
    S[3], I[3], R[3] = S[0], I[0], R[0]
    S[3, -1] = S[0, -1] + 0.25
    users = rng.integers(0, min(N, 12), B)
    users[:min(B, 4)] = np.arange(min(B, 4))[::-1]
    rng.shuffle(users)
    return (torch.as_tensor(S[users]), torch.as_tensor(I[users]),
            torch.as_tensor(R), torch.as_tensor(users, dtype=torch.int64))


def host_keys(sims, nbrs, third):
    return np.concatenate([sims.numpy().view(np.uint32),
                           nbrs.numpy().view(np.uint32),
                           third.numpy().view(np.uint32)], axis=1)


def assert_same_plan(got, want):
    assert got.n_unique == want.n_unique
    assert np.array_equal(got.unique_rows, want.unique_rows)
    assert np.array_equal(got.scatter, want.scatter)
    assert got.unique_rows.dtype == got.scatter.dtype == np.int64


def _dedup_key(cuda, sims, nbrs, R, users):
    """The key as ``recommend_batch`` hands it over: the sims a column
    slice of a wider sort, the rows gathered from the arena by user id."""
    wide = torch.zeros((sims.shape[0], sims.shape[1] + 13))
    wide[:, :sims.shape[1]] = sims
    return (wide.to(cuda)[:, :sims.shape[1]], nbrs.to(cuda), R.to(cuda),
            users.to(cuda))


@pytest.mark.parametrize("B", [1, 32, 256])
@pytest.mark.parametrize("m", [58_541, 1001, 8153])
def test_key_dedup_kernel_plan_is_dedup_rows_plan(cuda, B, m):
    """Douban width, an odd width, and 8,153 items (a key of 8,193 words,
    one word past a probe block's edge)."""
    sims, nbrs, R, users = dedup_case(np.random.default_rng(B + m), B, 20,
                                      64, m)
    key = _dedup_key(cuda, sims, nbrs, R, users)
    before = launch_counts()["key_dedup"]
    hashes = key_dedup.probe(*key)
    first = key_dedup.verify(*key, hashes)
    torch.cuda.synchronize()
    assert launch_counts()["key_dedup"] == before + 2
    words = key_words(*key)
    assert torch.equal(hashes, probe_ref(words))
    assert torch.equal(first, verify_ref(words, hashes))
    assert_same_plan(plan_of_first(first),
                     dedup_rows(host_keys(sims, nbrs, R[users])))


@pytest.mark.parametrize("B", [1, 32, 256])
def test_key_dedup_kernel_predict_keys(cuda, B):
    """(sims, ids, item): the third segment one word a row, not
    gathered."""
    sims, nbrs, _, users = dedup_case(np.random.default_rng(B), B, 20, 64, 5)
    items = (users % 3).to(torch.int32).view(-1, 1)
    key = (sims.to(cuda), nbrs.to(cuda), items.to(cuda), None)
    hashes = key_dedup.probe(*key)
    first = key_dedup.verify(*key, hashes)
    words = key_words(*key)
    assert torch.equal(hashes, probe_ref(words))
    assert_same_plan(plan_of_first(first),
                     dedup_rows(host_keys(sims, nbrs, items)))


def test_key_dedup_kernel_signed_zero_and_nan_payloads(cuda):
    """-0.0 is not 0.0 and NaNs with other payloads differ, in a sim and
    in the rating row's last word; the same NaN bits are shared."""
    bits = np.array([0x00000000, 0x80000000, 0x7FC00000, 0x7FC00001,
                     0x7FC00000, 0x00000000], np.uint32)
    col = torch.as_tensor(bits.view(np.float32).copy())
    sims = torch.zeros((12, 20))
    sims[:6, 7] = col
    R = torch.ones((12, 58_541))
    R[6:, -1] = col
    users = torch.arange(12)
    nbrs = torch.zeros((12, 20), dtype=torch.int32)
    key = (sims.to(cuda), nbrs.to(cuda), R.to(cuda), users.to(cuda))
    plan = plan_of_first(key_dedup.first_twins(*key))
    want = dedup_rows(host_keys(sims, nbrs, R))
    assert_same_plan(plan, want)
    assert plan.scatter.tolist() == [0, 1, 2, 3, 2, 0, 4, 5, 6, 7, 6, 4]


@pytest.mark.parametrize("B", [32, 256])
def test_key_dedup_kernel_forced_collisions(cuda, B):
    """The verify fed all-equal hashes compares every earlier key and
    still shares only identical ones (near-twins differ in their last
    word or their last sim)."""
    sims, nbrs, R, users = dedup_case(np.random.default_rng(7 * B), B, 20,
                                      64, 58_541)
    key = _dedup_key(cuda, sims, nbrs, R, users)
    zeros = torch.zeros(B, dtype=torch.int64, device=cuda)
    first = verify_cuda(*key, zeros)
    assert torch.equal(first, key_dedup.first_twins(*key))
    assert_same_plan(plan_of_first(first),
                     dedup_rows(host_keys(sims, nbrs, R[users])))


def test_read_calls_dedup_on_card_in_two_launches(cuda):
    """Each ``recommend_batch`` and ``predict_batch`` call launches the
    dedup's probe and verify once each, and the card's server scores as
    many unique rows as the CPU's."""
    R = _ratings(np.random.default_rng(3), 120, 40)
    users = [0, 5, 5, 17, 0, 119, 5, 3, 17]
    stats = {}
    for dev in ("cuda", "cpu"):
        srv = CFServer(R, ServerConfig(capacity_extra=8), device=dev)
        srv.onboard_user(R[5])           # a twin of user 5 joins
        users_now = users + [srv.state.n_active - 1]
        for call in (lambda: srv.recommend_batch(users_now, n=5,
                                                 k_neighbors=7),
                     lambda: srv.predict_batch(users_now, [4] * 10, k=7)):
            before = launch_counts()["key_dedup"]
            call()
            if dev == "cuda":
                torch.cuda.synchronize()
                assert launch_counts()["key_dedup"] == before + 2
        stats[dev] = (srv.stats.queries, srv.stats.query_unique)
    assert stats["cuda"] == stats["cpu"]
    assert stats["cuda"][1] < stats["cuda"][0]


def test_key_dedup_counts_on_card_what_it_counts_on_meta(cuda):
    """One dedup reports the pair's formula once, on the card as on
    ``meta``, and launches twice."""
    from repro_torch.launch.trace import Counter
    sims, nbrs, R, users = dedup_case(np.random.default_rng(5), 33, 20, 64,
                                      301)
    args = (sims, nbrs, R, users)
    card_args = [a.to(cuda) for a in args]
    plain = key_dedup.first_twins(*card_args)
    before = launch_counts()["key_dedup"]
    with Counter() as card:
        out = key_dedup.first_twins(*card_args)
    torch.cuda.synchronize()
    assert launch_counts()["key_dedup"] == before + 2
    with Counter() as meta:
        key_dedup.first_twins(*[a.to("meta") for a in args])
    assert card.kernels == meta.kernels
    assert card.kernels["key_dedup"]["calls"] == 1
    assert (card.flops, card.flops_f32, card.bytes) == (
        meta.flops, meta.flops_f32, meta.bytes)
    assert torch.equal(out, plain)


def _launched(name, fn, *args, **kwargs):
    """Run ``fn`` and check that it launched kernel ``name`` exactly once."""
    before = launch_counts()[name]
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + 1
    return out


@pytest.mark.parametrize("c,N", [(1, 1), (2, 64), (8, 513), (8, 700),
                                 (16, 2048), (8, 32896)])
@pytest.mark.parametrize("tol", [1e-6, 0.05])
def test_twin_probe_kernel_exact(cuda, c, N, tol):
    """Ragged widths, ties at the tolerance's edge, NaN and SENTINEL
    columns; a tol that an int argument would cut to 0 must still match
    the near columns."""
    rng = np.random.default_rng(c * N)
    rows = np.round(rng.uniform(-1, 1, (c, N)), 2).astype(np.float32)
    s0 = rows[:, N // 3].copy()
    if N >= 8:
        rows[:, 1] = s0 + np.float32(tol)
        rows[:, 2] = np.nextafter(s0 + np.float32(tol), np.float32(2))
        rows[0, 3] = np.nan
        rows[:, 4] = s0
        rows[:, 5:8] = -2.0
    rows_t = torch.as_tensor(rows, device=cuda)
    s0_t = torch.as_tensor(s0, device=cuda)
    mask, count = _launched("twin_probe", twin_probe, rows_t, s0_t, tol=tol)
    rmask, rcount = twin_probe_ref(rows_t, s0_t, tol)
    assert torch.equal(mask, rmask) and int(count) == int(rcount)
    assert int(count) == int(mask.sum()) and bool(mask[N // 3])
    if N >= 8:
        assert bool(mask[4]) and not bool(mask[3])


def test_twin_probe_kernel_refuses_other_dtypes(cuda):
    rows = torch.zeros((2, 9), dtype=torch.float64, device=cuda)
    with pytest.raises(NotImplementedError, match="float64"):
        twin_probe(rows, rows[:, 0])


@pytest.mark.parametrize("s,m", [(1, 1), (8, 16), (37, 211), (300, 700),
                                 (458, 58541)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_verify_rows_kernel_exact(cuda, s, m, dtype):
    """Ragged and odd widths (58,541: rows off 16-byte alignment), planted
    twins, one differing element at the head or the tail of a row."""
    rng = np.random.default_rng(s + m)
    C = rng.integers(0, 6, (s, m))
    C[rng.choice(s, size=min(4, s), replace=False)] = C[s // 2]
    if s >= 8:
        C[1] = C[s // 2]
        C[1, 0] += 1
        C[2] = C[s // 2]
        C[2, -1] += 1
    valid = rng.random(s) < 0.8
    Ct = torch.as_tensor(C, device=cuda).to(dtype)
    r0 = Ct[s // 2].clone()
    vt = torch.as_tensor(valid, device=cuda)
    out = _launched("verify_rows", verify_rows, Ct, r0, vt)
    assert torch.equal(out, verify_rows_ref(Ct, r0, vt))
    assert bool(out[s // 2]) == bool(valid[s // 2])


def _row_parts(row: torch.Tensor) -> tuple[int, int]:
    """(head, tail start) of a row as the kernel splits it: elements before
    its first 16-byte boundary, then whole 16-byte chunks."""
    E = row.element_size()
    head = min(row.numel(), (16 - row.data_ptr() % 16) % 16 // E)
    return head, head + (row.numel() - head) * E // 16 * (16 // E)


@pytest.mark.parametrize("m", [15, 16, 17, 31, 33, 58541])
@pytest.mark.parametrize("c_off,r_off", [(0, 0), (3, 7), (9, 1)])
@pytest.mark.parametrize("dtype", [torch.int8, torch.float32])
def test_verify_rows_kernel_head_body_tail(cuda, m, c_off, r_off, dtype):
    """32 rows, so that at odd m rows start at every offset mod 16 (C and
    r0 sit c_off and r_off elements into larger buffers, so r0's offset
    differs from the rows'); rows take turns to differ in one element of
    their head, the first or last element of their body, their tail, or
    nowhere."""
    s = 32
    rng = np.random.default_rng(m + c_off)
    target = torch.as_tensor(rng.integers(-100, 100, m), device=cuda).to(
        dtype)
    cbuf = torch.zeros(c_off + s * m + 16, dtype=dtype, device=cuda)
    C = cbuf[c_off:c_off + s * m].view(s, m)
    C.copy_(target.expand(s, m))
    rbuf = torch.zeros(r_off + m + 16, dtype=dtype, device=cuda)
    r0 = rbuf[r_off:r_off + m]
    r0.copy_(target)
    expect, hit = [], set()
    for i in range(s):
        head, tail = _row_parts(C[i])
        pos = {1: 0 if head else None,
               2: head if tail > head else None,
               3: tail - 1 if tail > head else None,
               4: tail if tail < m else None}.get(i % 5)
        if pos is not None:
            C[i, pos] += 1
            hit.add(i % 5)
        expect.append(pos is None)
    if dtype == torch.int8 and m % 2:
        assert len({C[i].data_ptr() % 16 for i in range(s)}) == 16
    if m >= 33:
        assert hit == {1, 2, 3, 4}
    valid = torch.ones(s, dtype=torch.bool, device=cuda)
    valid[5] = False
    expect[5] = False
    out = _launched("verify_rows", verify_rows, C, r0, valid)
    assert torch.equal(out, verify_rows_ref(C, r0, valid))
    assert out.tolist() == expect


def test_verify_rows_kernel_signed_zero_nan_and_invalid(cuda):
    r0 = torch.tensor([0.0, 1.0, 2.0, 0.0, 5.0], device=cuda)
    C = r0.repeat(5, 1)
    C[1, 0] = -0.0                                # -0.0 == 0.0
    C[2, 2] = float("nan")                        # NaN equals nothing
    valid = torch.tensor([True, True, True, False, True], device=cuda)
    out = _launched("verify_rows", verify_rows, C, r0, valid)
    assert out.tolist() == [True, True, False, False, True]
    assert torch.equal(out, verify_rows_ref(C, r0, valid))
    r0_nan = r0.clone()
    r0_nan[2] = float("nan")
    assert not _launched("verify_rows", verify_rows, C, r0_nan,
                         valid).any()
    none = torch.zeros(5, dtype=torch.bool, device=cuda)
    assert not _launched("verify_rows", verify_rows, C, r0, none).any()


def test_verify_rows_kernel_promotion_and_other_dtypes(cuda):
    """int8 against float32 promotes to float32 (the f32 kernel); a dtype
    the kernel has no instance for raises."""
    C = torch.randint(0, 6, (9, 33), dtype=torch.int8, device=cuda)
    out = _launched("verify_rows", verify_rows, C, C[3].float(),
                    torch.ones(9, dtype=torch.bool, device=cuda))
    assert bool(out[3])
    with pytest.raises(NotImplementedError, match="int32"):
        verify_rows(C.int(), C[3].int(), torch.ones(9, dtype=torch.bool,
                                                    device=cuda))


def _subnormals(*units):
    """float32 subnormals: each unit times the least one."""
    return np.array(units, dtype=np.uint32).view(np.float32)


def _health_arena(cuda, n, L, m, off_v, off_r, seed):
    """n rows as the server keeps them (each list ascending with a SENTINEL
    head and ties, small integer ratings, their norms), the lists and
    ratings ``off_v`` and ``off_r`` elements into larger buffers so that
    rows start at several offsets mod 16 bytes; rows follow each other
    with no gap, and each row's last list value exceeds the next row's
    first."""
    rng = np.random.default_rng(seed)
    vals = np.sort(np.round(rng.uniform(-1, 1, (n, L)), 1), axis=1)
    vals[np.arange(L)[None, :] < rng.integers(0, L + 1, (n, 1))] = SENTINEL
    if L >= 2:
        vals[:, 0], vals[:, -1] = SENTINEL, 1.0
    ratings = rng.integers(0, 6, (n, m)).astype(np.float64)
    norms = np.sqrt((ratings ** 2).sum(axis=1))
    vbuf = torch.zeros(off_v + n * L + 8, device=cuda)
    rbuf = torch.zeros(off_r + n * m + 8, device=cuda)
    sv = vbuf[off_v:off_v + n * L].view(n, L)
    rt = rbuf[off_r:off_r + n * m].view(n, m)
    sv.copy_(torch.as_tensor(vals, dtype=torch.float32))
    rt.copy_(torch.as_tensor(ratings, dtype=torch.float32))
    return sv, rt, torch.as_tensor(norms, dtype=torch.float32, device=cuda)


def _plant_health_faults(sv, rt, nm):
    """Plant one fault or one sound special case a row, from row 0 on.
    Returns the rows' expected flags (rows after the planted ones True).
    The faults: NaN, +inf and -inf in the first column, the last column and
    the first 16-byte aligned column of a list and of a rating row; a
    descending pair that straddles the head and the body, two chunks, two
    lanes' loads, two warps' tiles, the body and the tail; a descending
    subnormal pair; norms NaN, -1, +inf and minus the least subnormal.
    Sound: equal values, all SENTINEL, ascending subnormals with -0.0 and
    0.0 side by side both ways, a -0.0 norm."""
    n, L = sv.shape
    expect = [True] * n
    row = 0

    def take(ok):
        nonlocal row
        assert row < n, "too few rows for the planted cases"
        expect[row] = ok
        row += 1
        return row - 1

    for arr in (sv, rt):
        width = arr.shape[1]
        for value in (float("nan"), float("inf"), float("-inf")):
            for where in ("first", "last", "aligned"):
                head, tail = _row_parts(arr[row])
                col = {"first": 0, "last": width - 1,
                       "aligned": head if tail > head else None}[where]
                if col is not None:
                    arr[take(False), col] = value
    for step in (0, 4, 4 * 32, 4 * 32 * 8):
        head, tail = _row_parts(sv[row])
        j = head + step if tail > head else None
        if j is not None and 1 <= j < L:
            r = take(False)
            sv[r, j] = sv[r, j - 1] - 0.5
    head, tail = _row_parts(sv[row])
    if 1 <= tail < L:
        r = take(False)
        sv[r, tail] = sv[r, tail - 1] - 0.5
    if L >= 2:
        r = take(False)
        sv[r, 1] = sv[r, 0] - 0.5
    if L >= 8:
        tiny = torch.as_tensor(_subnormals(1, 2, 3, 5), device=sv.device)
        r = take(True)
        sv[r] = 0.0
        sv[r, :2] = torch.tensor([-0.0, 0.0])
        sv[r, 2:4] = torch.tensor([0.0, -0.0])
        sv[r, L - 4:] = tiny
        r = take(False)
        sv[r] = 0.0
        sv[r, L - 4:] = tiny.flip(0)
    r = take(True)
    sv[r] = 0.25
    r = take(True)
    sv[r] = SENTINEL
    for value in (float("nan"), -1.0, float("inf"),
                  -float(_subnormals(1)[0])):
        nm[take(False)] = value
    nm[take(True)] = -0.0
    return expect


@pytest.mark.parametrize("L,m", [(1, 1), (3, 3), (6, 7), (10, 1001),
                                 (2061, 7), (2061, 1001), (37, 1003)])
@pytest.mark.parametrize("off_v,off_r", [(0, 0), (1, 3), (3, 2)])
def test_live_rows_kernel_flags_equal_plain(cuda, L, m, off_v, off_r):
    """Every planted fault and sound special case (``_plant_health_faults``)
    at widths that exercise the scalar head, the body and the tail of both
    arrays, and at three row offsets: the kernel's flags equal the plain
    version's on the card and on the CPU, and the planted verdicts."""
    n = 48
    sv, rt, nm = _health_arena(cuda, n, L, m, off_v, off_r, L * m + off_v)
    expect = _plant_health_faults(sv, rt, nm)
    flags = _launched("verify_rows", live_rows_ok, sv, rt, nm, n)
    plain = live_rows_ok_ref(sv, rt, nm, n, 5)
    assert torch.equal(flags, plain)
    assert torch.equal(flags.cpu(), live_rows_ok(sv.cpu(), rt.cpu(),
                                                 nm.cpu(), n))
    assert flags.tolist() == expect


@pytest.mark.parametrize("n_active", [0, 1, 29, 40, 41, 45])
def test_live_rows_kernel_live_rows_only(cuda, n_active):
    """Rows at or past ``n_active`` are NaN everywhere and never read;
    ``n_active`` above the capacity sweeps every row and fails the arena
    (``arena_healthy`` is one launch, or none with no live row)."""
    n, L, m = 40, 301, 257
    sv, rt, nm = _health_arena(cuda, n, L, m, 1, 2, n_active)
    rt[3, 100] = float("inf")
    live = min(n_active, n)
    sv[live:], rt[live:], nm[live:] = (float("nan"),) * 3
    expect = [r != 3 for r in range(live)]
    before = launch_counts()["verify_rows"]
    flags = live_rows_ok(sv, rt, nm, n_active)
    ok = arena_healthy(sv, rt, nm, n_active)
    torch.cuda.synchronize()
    assert launch_counts()["verify_rows"] == before + (2 if live else 0)
    assert flags.shape == (live,) and flags.tolist() == expect
    assert torch.equal(flags, live_rows_ok_ref(sv, rt, nm, live, 4096))
    assert bool(ok) == (all(expect) and n_active <= n)


def test_arena_healthy_one_launch_on_card(cuda):
    """One health check on the card is one ``verify_rows`` launch (and its
    bool)."""
    sv, rt, nm = _health_arena(cuda, 33, 130, 77, 0, 1, 5)
    assert bool(_launched("verify_rows", arena_healthy, sv, rt, nm, 33))
    nm[32] = float("nan")
    assert not bool(_launched("verify_rows", arena_healthy, sv, rt, nm, 33))


@pytest.mark.parametrize("L,m", [(32_832, 58_541), (41_024, 27_278)])
def test_live_rows_kernel_at_arena_widths(cuda, L, m):
    """The Douban-width and MovieLens-width rows (a few of them): faults in
    the last column, at the tile crossings deep in the row, and one clean
    row, against the plain version."""
    n = 12
    sv, rt, nm = _health_arena(cuda, n, L, m, 0, 0, L)
    sv[1, L - 1] = float("nan")
    rt[2, m - 1] = float("-inf")
    head, _ = _row_parts(sv[3])
    j = head + 4 * 32 * 8 * 3                # a tile crossing
    sv[3, j] = sv[3, j - 1] - 0.5
    sv[4, L - 1] = sv[4, L - 2] - 0.5        # the last pair
    rt[5, m // 2] = float("nan")
    flags = _launched("verify_rows", live_rows_ok, sv, rt, nm, n)
    assert torch.equal(flags, live_rows_ok_ref(sv, rt, nm, n, 4096))
    assert flags.tolist() == [r not in (1, 2, 3, 4, 5) for r in range(n)]


def _same_bits(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("nb,hot,V,dim", [(1, 1, 1, 1), (4, 2, 50, 8),
                                          (33, 5, 200, 64),
                                          (1000, 8, 100000, 10),
                                          (7, 3, 37, 257)])
def test_embedding_bag_kernel_bitwise_plain(cuda, nb, hot, V, dim):
    """Ragged shapes, ids out of range on both sides, a validity mask and
    an infinite table entry behind a zero-weight slot (NaN, as in JAX)."""
    rng = np.random.default_rng(nb * hot + dim)
    table = rng.normal(size=(V, dim)).astype(np.float32)
    table[0, 0] = np.inf
    idx = rng.integers(-3, V + 3, (nb, hot)).astype(np.int32)
    w = rng.uniform(0, 1, (nb, hot)).astype(np.float32)
    mask = rng.random((nb, hot)) < 0.6
    args = [torch.as_tensor(x, device=cuda) for x in (table, idx, w, mask)]
    out = _launched("embedding_bag", embedding_bag, *args)
    clipped = torch.clamp(args[1].long(), 0, V - 1)
    ref = embedding_bag_ref(args[0], clipped, args[2] * args[3].float())
    assert _same_bits(out, ref)
    out1 = _launched("embedding_bag", embedding_bag, args[0], args[1])
    assert _same_bits(out1, embedding_bag_ref(
        args[0], clipped, torch.ones((nb, hot), device=cuda)))


def test_embedding_bag_kernel_refuses_other_dtypes(cuda):
    table = torch.zeros((4, 3), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError, match="bfloat16"):
        embedding_bag(table, torch.zeros((2, 2), dtype=torch.int32,
                                         device=cuda))


def _device_ops_per_call(fn, calls=3):
    """Device operations (kernels, fills, copies) the profiler sees per
    call of ``fn``, after one call outside the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA)
    return n / calls


def _probe_rows(rng, c, N):
    rows = np.round(rng.uniform(-1, 1, (c, N)), 2).astype(np.float32)
    s0 = rows[:, N // 2].copy()
    rows[:, N - 1] = s0
    rows[:, 0] = s0
    if N >= 8:
        rows[c - 1, N - 2] = np.nan
        rows[:, N - 3] = -2.0
    return rows, s0


@pytest.mark.parametrize("c", [1, 4, 8, 9, 16, 17])
@pytest.mark.parametrize("N", [5, 1027, 4096, 32896, 100003])
def test_twin_probe_kernel_instantiations(cuda, c, N):
    """Each template probe count (4, 8, 16) and the run-time one (1, 9,
    17), on the float4 path (N % 4 == 0) and the scalar one."""
    rows, s0 = _probe_rows(np.random.default_rng(c * N), c, N)
    rows_t = torch.as_tensor(rows, device=cuda)
    s0_t = torch.as_tensor(s0, device=cuda)
    mask, count = _launched("twin_probe", twin_probe, rows_t, s0_t,
                            tol=0.01)
    rmask, rcount = twin_probe_ref(rows_t, s0_t, 0.01)
    assert torch.equal(mask, rmask) and int(count) == int(rcount)
    assert int(count) == int(mask.sum()) >= 3 - (N < 8)


@pytest.mark.parametrize("c,N", [(8, 4096), (9, 1028), (8, 1027)])
def test_twin_probe_kernel_unaligned_rows(cuda, c, N):
    """Rows that start one element past a 16-byte boundary (a view into a
    larger buffer) take the scalar path, with the same answer."""
    rows, s0 = _probe_rows(np.random.default_rng(N), c, N)
    buf = torch.zeros(c * N + 1, device=cuda)
    view = buf[1:].view(c, N)
    view.copy_(torch.as_tensor(rows))
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    s0_t = torch.as_tensor(s0, device=cuda)
    mask, count = _launched("twin_probe", twin_probe, view, s0_t, tol=0.01)
    rmask, rcount = twin_probe_ref(view, s0_t, 0.01)
    assert torch.equal(mask, rmask) and int(count) == int(rcount)


def test_twin_probe_two_streams_keep_their_counts(cuda):
    """Calls on two streams at once, interleaved without a sync between
    them: each keeps its own ticket, so each count is its own input's."""
    rng = np.random.default_rng(11)
    c, N = 8, 1 << 20
    inputs = []
    for want in (0, 1):
        rows = rng.uniform(-1, 1, (c, N)).astype(np.float32)
        s0 = rows[:, 7].copy()
        hits = rng.choice(N, 1000 + 2345 * want, replace=False)
        rows[:, hits] = s0[:, None]
        rows_t = torch.as_tensor(rows, device=cuda)
        s0_t = torch.as_tensor(s0, device=cuda)
        inputs.append((rows_t, s0_t, twin_probe_ref(rows_t, s0_t, 0.0)))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    out = [[], []]
    for _ in range(40):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                rows_t, s0_t, _ = inputs[k]
                out[k].append(twin_probe(rows_t, s0_t, tol=0.0))
    torch.cuda.synchronize()
    assert int(inputs[0][2][1]) != int(inputs[1][2][1])
    for k in (0, 1):
        rmask, rcount = inputs[k][2]
        for mask, count in out[k]:
            assert int(count) == int(rcount)
            assert torch.equal(mask, rmask)


def test_twin_probe_is_one_kernel_a_call(cuda):
    rows, s0 = _probe_rows(np.random.default_rng(3), 8, 32896)
    rows_t = torch.as_tensor(rows, device=cuda)
    s0_t = torch.as_tensor(s0, device=cuda)
    assert _device_ops_per_call(
        lambda: twin_probe(rows_t, s0_t, tol=1e-6)) == 1


def _bag_inputs(cuda, rng, nb, hot, V, dim):
    table = rng.normal(size=(V, dim)).astype(np.float32)
    table[0, 0] = np.inf
    idx = rng.integers(-3, V + 3, (nb, hot)).astype(np.int32)
    w = rng.uniform(0, 1, (nb, hot)).astype(np.float32)
    w[0, 0] = 0.0
    mask = rng.random((nb, hot)) < 0.6
    return [torch.as_tensor(x, device=cuda) for x in (table, idx, w, mask)]


@pytest.mark.parametrize("hot", [1, 3, 8, 16, 33])
@pytest.mark.parametrize("dim", [1, 10, 16, 128])
@pytest.mark.parametrize("layout", ["column", "pair"])
def test_embedding_bag_kernel_instantiations(cuda, hot, dim, layout):
    """Each template hot (1, 8, 16) and the run-time one (3, 33: scalar
    slot loads, and a chunked loop), both thread layouts (the pair layout
    takes columns two at a time where dim is even), with weights and a
    mask folded in and with neither: bit for bit."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    table, idx, w, mask = _bag_inputs(cuda, np.random.default_rng(
        hot * 131 + dim), 301, hot, 97, dim)
    V = table.shape[0]
    clipped = torch.clamp(idx.long(), 0, V - 1)
    out = _launched("embedding_bag", embedding_bag_cuda, table, idx, w,
                    mask, layout=layout)
    assert _same_bits(out, embedding_bag_ref(table, clipped,
                                             w * mask.float()))
    out1 = _launched("embedding_bag", embedding_bag_cuda, table, idx,
                     layout=layout)
    assert _same_bits(out1, embedding_bag_ref(
        table, clipped, torch.ones(idx.shape, device=cuda)))
    outm = _launched("embedding_bag", embedding_bag_cuda, table, idx,
                     None, mask, layout=layout)
    assert _same_bits(outm, embedding_bag_ref(table, clipped,
                                              mask.float()))


@pytest.mark.parametrize("shift", ["idx", "w", "mask", "table"])
def test_embedding_bag_kernel_unaligned_views(cuda, shift):
    """One input a view one element past its buffer's start (hot = 8, so
    the slot loads would be vectors, and dim = 10, so the rows would be
    read in pairs): the kernel takes the scalar loads or the column
    layout instead, with the same bits."""
    table, idx, w, mask = _bag_inputs(cuda, np.random.default_rng(8), 517,
                                      8, 203, 10)
    t = {"idx": idx, "w": w, "mask": mask, "table": table}[shift]
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    args = {"idx": idx, "w": w, "mask": mask, "table": table,
            shift: view}
    out = _launched("embedding_bag", embedding_bag, args["table"],
                    args["idx"], args["w"], args["mask"])
    ref = embedding_bag_ref(table, torch.clamp(idx.long(), 0, 202),
                            w * mask.float())
    assert _same_bits(out, ref)


def test_embedding_bag_host_forms_on_card(cuda):
    """Forms the kernel does not take in itself (float16 weights, a float
    mask, int64 ids) go through the host steps first, with the plain
    version's bits."""
    table, idx, w, mask = _bag_inputs(cuda, np.random.default_rng(4), 64,
                                      8, 50, 16)
    ids64 = idx.long() + (1 << 32)                 # wraps back to idx
    clipped = torch.clamp(idx.long(), 0, 49)
    w16 = w.half()
    cases = [(ids64, w, mask, w * mask.float()),
             (idx, w16, mask, (w16 * mask.half()).float()),
             (idx, w, mask.float(), w * mask.float()),
             (idx, None, mask.float(), mask.float())]
    for ids, ww, mm, weff in cases:
        out = _launched("embedding_bag", embedding_bag, table, ids, ww, mm)
        assert _same_bits(out, embedding_bag_ref(table, clipped, weff))


def test_embedding_bag_is_one_kernel_a_call(cuda):
    """float32 weights, a bool mask and int32 ids: one launch a call, the
    clip and the mask's product inside it."""
    table, idx, w, mask = _bag_inputs(cuda, np.random.default_rng(6), 4096,
                                      8, 1000, 10)
    assert _device_ops_per_call(
        lambda: embedding_bag(table, idx, w, mask)) == 1
    assert _device_ops_per_call(lambda: embedding_bag(table, idx)) == 1


def _card_state(cuda, rng, n=300, m=90, extra=16):
    """A card arena with a burst of twins and fresh rows in its write
    region, and its CPU copy."""
    R = _ratings(rng, n, m)
    srv = CFServer(R, ServerConfig(capacity_extra=extra, c_probes=4),
                   device="cuda")
    fresh = _ratings(np.random.default_rng(5), extra // 2, m)
    for r in [*R[:extra // 2], *fresh][:extra - 2]:
        assert srv.onboard_user(r).ok
    return R, srv


def test_rotation_plan_finalize_equals_frozen_rotation_on_card(cuda):
    rng = np.random.default_rng(0)
    _, srv = _card_state(cuda, rng)
    n_base, st = srv.n_base, srv.state
    plan = RotationPlan(st, n_base=n_base, extra=9, chunk_rows=37)
    launches = launch_counts()["list_merge"]
    plan.step(st, 80)
    assert launch_counts()["list_merge"] > launches
    cache = update.init_cache(st.ratings)
    for u, i, v in ((3, 2, 5.0), (n_base + 1, 4, 1.0), (17, 0, 0.0)):
        st, cache = update.add_rating(st, cache, u, i, v)
        plan.note_write(u)
    assert plan.restarts == 1
    while not plan.done:
        plan.step(st, 80)
    st, cache = update.add_rating(st, cache, 40, 7, 2.0)   # dirty
    plan.note_write(40)
    out = state_to_numpy(plan.finalize(st))
    ref = state_to_numpy(rotate_arena_frozen(st, n_base=n_base,
                                             n_frozen=plan.n_frozen,
                                             extra=9))
    host = state_to_numpy(rotate_arena_frozen(
        state_from_numpy(state_to_numpy(st), "cpu"), n_base=n_base,
        n_frozen=plan.n_frozen, extra=9))
    for key in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(out[key], host[key], err_msg=key)


@pytest.mark.parametrize("extra", [0, 8])
def test_tiled_build_on_card_matches_the_whole_matrix(cuda, monkeypatch,
                                                      extra):
    """The tiled ``build_state`` on the card, tiles of 64 over 300 rows
    (mirrors and a ragged edge), against the whole-matrix build it
    replaced (``cosine_matrix``, a stable sort of every row); with
    ``hand_over`` and no free slots the arena keeps the card's R."""
    rng = np.random.default_rng(29)
    R = _ratings(rng, 300, 517)
    R[7] = R[3]                                  # a twin: a tie of 1.0
    Rc = torch.as_tensor(R, device=cuda)
    monkeypatch.setattr(knn, "TILE_ROWS", 64)
    st = build_state(Rc, capacity_extra=extra, hand_over=True)
    n, N = 300, 300 + extra
    full = torch.full((N, N), SENTINEL, device=cuda)
    full[:n, :n] = similarity.cosine_matrix(Rc)
    vals, idx = torch.sort(full, dim=1, stable=True)
    assert (st.ratings is Rc) == (extra == 0)
    torch.testing.assert_close(st.norms[:n], similarity.row_norms(Rc))
    assert lists_match(vals.cpu().numpy(), idx.int().cpu().numpy(),
                       st.sim_vals.cpu().numpy(), st.sim_idx.cpu().numpy(),
                       1e-6) is None


def test_add_rating_on_card_matches_cpu_plain_path(cuda):
    rng = np.random.default_rng(1)
    R = _ratings(rng, 400, 120)
    states = {d: build_state(torch.as_tensor(R, device=d),
                             capacity_extra=8) for d in ("cuda", "cpu")}
    caches = {d: update.init_cache(st.ratings) for d, st in states.items()}
    assert torch.equal(caches["cuda"].dots.cpu(), caches["cpu"].dots)
    for u, i, v in ((7, 3, 5.0), (7, 3, 2.0), (399, 0, 0.0), (12, 119, 4.0)):
        for d in states:
            states[d], caches[d] = update.add_rating(states[d], caches[d],
                                                     u, i, v)
    a, b = state_to_numpy(states["cuda"]), state_to_numpy(states["cpu"])
    for key in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert torch.equal(caches["cuda"].dots.cpu(), caches["cpu"].dots)
    assert torch.equal(caches["cuda"].sq.cpu(), caches["cpu"].sq)


def test_checkpoint_round_trip_from_card(cuda, tmp_path):
    rng = np.random.default_rng(2)
    _, srv = _card_state(cuda, rng)
    st = srv.state
    checkpoint.save(str(tmp_path), 5, st, extra={"n_base": srv.n_base})
    template = st._replace(**{f: getattr(st, f)[:0] for f in
                              ("ratings", "norms", "sim_vals", "sim_idx")})
    out, step, extra = checkpoint.restore(str(tmp_path), template)
    assert (step, extra["n_base"]) == (5, srv.n_base)
    assert out.n_active == st.n_active
    for a, b in zip(out[:4], st[:4]):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)


def test_durable_server_on_card_recovers_bit_exact(cuda, tmp_path):
    """Crash at the incremental swap's commit record, recover on the card:
    equal to an uncrashed card server after the same requests."""
    rng = np.random.default_rng(3)
    R = _ratings(rng, 200, 60)
    fresh = _ratings(np.random.default_rng(4), 6, 60)
    stream = [R[3], fresh[0], R[9], fresh[1], R[3], fresh[2], R[50],
              fresh[3], R[60], fresh[4], R[70], fresh[5]]

    def cfg(tag):
        return ServerConfig(
            capacity_extra=8, c_probes=4,
            snapshot=SnapshotConfig(every=5, dir=str(tmp_path / f"{tag}-s")),
            wal=WalConfig(dir=str(tmp_path / f"{tag}-w")),
            rotation=RotationConfig(budget_rows=64))

    def drive(srv, ops):
        for i, r in ops:
            assert srv.onboard_user(r).ok
            assert srv.add_rating(i * 7 % 200, i % 60, 1.0 + i % 5)

    oracle = CFServer(R, cfg("oracle"), device="cuda")
    drive(oracle, enumerate(stream))
    victim = CFServer(R, cfg("victim"), device="cuda")
    install_crash(victim, "rotation.commit_post_wal")
    with pytest.raises(SimulatedCrash):
        drive(victim, enumerate(stream))
    recovered = CFServer.recover(R, cfg("victim"), device="cuda")
    done = recovered.state.n_active - 200
    drive(recovered, list(enumerate(stream))[done:])
    a, b = state_to_numpy(recovered.state), state_to_numpy(oracle.state)
    for key in ("ratings", "norms", "sim_vals", "sim_idx", "n_active"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert recovered.n_base == oracle.n_base


def test_replica_repair_on_card_tensors(cuda):
    rng = np.random.default_rng(6)
    _, srv = _card_state(cuda, rng)
    st = srv.state
    good = [t.clone() for t in st[:4]]
    arena = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=2))
    st.sim_vals[[3, 90, 150]] = float("nan")
    st.ratings[41, 5] = float("inf")
    st.norms[120] = -1.0
    assert list(arena.bad_rows(st)) == [3, 41, 90, 120, 150]
    fixed, rows = arena.repair(st)
    assert fixed is st and list(rows) == [3, 41, 90, 120, 150]
    for a, b in zip(st[:4], good):
        assert a.is_cuda and torch.equal(a, b)
    # Unrecoverable (r = 1, the shard's only replica lost): untouched.
    arena = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=1))
    arena.kill_node(2)
    lo = arena._slices[2].start
    st.sim_vals[[lo, 0]] = float("nan")
    before = [t.clone() for t in st[:4]]
    fixed, rows = arena.repair(st)
    assert fixed is None and list(rows) == [0, lo]
    for a, b in zip(st[:4], before):
        assert torch.equal(a.nan_to_num(9.0), b.nan_to_num(9.0))


def test_kill_replica_on_card_heals_without_similarity_calls(cuda):
    rng = np.random.default_rng(7)
    R = _ratings(rng, 300, 90)
    srv = CFServer(R, ServerConfig(
        capacity_extra=8, c_probes=4,
        replication=ReplicationConfig(n_shards=4, r=2, rebuild_rows=50)),
        device="cuda")
    for r in (R[4], _ratings(rng, 1, 90)[0], R[4]):
        assert srv.onboard_user(r).ok
    n = srv.state.n_active
    good = [t[:n].clone() for t in srv.state[:4]]
    before = srv.recommend(5, n=5)
    forbid_similarity_kernels(srv)
    kill_replica(srv, 1)
    assert srv.recommend(5, n=5) == before
    while srv.replicas.degraded():
        srv.recommend(5, n=5)
    assert srv.stats.repairs == 1 and srv.stats.rollbacks == 0
    for a, b in zip(srv.state[:4], good):
        assert torch.equal(a[:n], b)


@pytest.mark.parametrize("n_rows", [1, 64, 333, 4096])
def test_chunked_base_merge_on_card(cuda, n_rows):
    """The base merge of the leading ``n_rows`` rows (all 700 at 4,096) is
    one ``list_merge`` launch, equal bit for bit to those rows of the
    head-padded ``merge_insert`` over every row and to the plain merge on
    the CPU."""
    rng = np.random.default_rng(8)
    st = build_state(torch.as_tensor(_ratings(rng, 700, 80), device=cuda))
    k = 32
    sims = torch.as_tensor(rng.uniform(-1, 1, (k, 700)).astype(np.float32),
                           device=cuda)
    sims[5] = sims[2]
    ids = 700 + torch.arange(k, device=cuda)
    whole = merge_insert(
        torch.cat([torch.full((700, k), SENTINEL, device=cuda), st.sim_vals],
                  dim=1),
        torch.cat([torch.full((700, k), -1, dtype=torch.int32, device=cuda),
                   st.sim_idx], dim=1), sims.T, ids.to(torch.int32))
    rows = slice(0, n_rows)
    before = launch_counts()["list_merge"]
    out = maintenance.merge_new_users_into_base(
        st.sim_vals[rows], st.sim_idx[rows], sims[:, rows], ids)
    torch.cuda.synchronize()
    assert launch_counts()["list_merge"] == before + 1
    host = maintenance.merge_new_users_into_base(
        st.sim_vals[rows].cpu(), st.sim_idx[rows].cpu(), sims[:, rows].cpu(),
        ids.cpu())
    for a, b, c in zip(out, whole, host):
        assert torch.equal(a, b[rows]) and torch.equal(a.cpu(), c)


@pytest.mark.parametrize("maintain", [False, True])
def test_buffered_burst_on_card_matches_plain_path(cuda, maintain):
    rng = np.random.default_rng(9)
    n, m, c = 500, 120, 6
    R = _ratings(rng, n, m)
    fresh = _ratings(np.random.default_rng(10), 5, m)
    R_new = np.stack([R[3], fresh[0], R[40], fresh[0], fresh[1], R[3],
                      fresh[1], fresh[2], fresh[3], fresh[4], fresh[0]])
    probes = torch.as_tensor(rng.integers(0, n, (R_new.shape[0], c)))
    outs = {}
    for d in ("cuda", "cpu"):
        st = build_state(torch.as_tensor(R, device=d))
        outs[d] = onboard_batch_buffered(
            st, torch.as_tensor(R_new), probes, s_max=set0_cap(n),
            maintain=maintain)
    a, b = outs["cuda"], outs["cpu"]
    found = b[2].found
    assert found.any() and (~found).any()
    for name in ("found", "n_candidates", "overflowed"):
        assert torch.equal(getattr(a[2], name).cpu(), getattr(b[2], name))
    assert torch.equal(a[2].twin_idx.cpu()[found], b[2].twin_idx[found])
    assert lists_match(b[0].numpy(), b[1].numpy(), a[0].cpu().numpy(),
                       a[1].cpu().numpy(), 1e-6) is None
    if maintain:
        (av, ai), (bv, bi) = a[3], b[3]
        assert av.is_cuda and av.shape == (n, n + R_new.shape[0])
        assert lists_match(bv.numpy(), bi.numpy(), av.cpu().numpy(),
                           ai.cpu().numpy(), 1e-6) is None



# ---------------------------------------------------------------------------
# The CF model family and the sharded burst (NCCL, one rank)
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl1(cuda):
    """A one-rank NCCL process group on the card, torn down after."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield cuda
    dist.destroy_process_group()


def _sharded_case(n=512, m=120, c=6):
    rng = np.random.default_rng(21)
    R = _ratings(rng, n, m)
    fresh = _ratings(np.random.default_rng(22), 4, m)
    R_new = np.stack([R[3], fresh[0], R[40], fresh[0], fresh[1], R[3],
                      fresh[2], fresh[3], fresh[1]])
    probes = torch.as_tensor(rng.integers(0, n, (R_new.shape[0], c)))
    return R, R_new, probes


@pytest.mark.parametrize("maintain", [False, True])
def test_sharded_burst_on_card_matches_plain_path(nccl1, maintain):
    """NCCL, one rank: the sharded burst on the card against the buffered
    burst's plain path on the CPU (flags exact, lists within 1e-6) and
    against the buffered burst on the card (bit for bit); the maintained
    lists come from the list_merge kernel."""
    from repro_torch.core.twinsearch_sharded import onboard_batch_sharded
    from repro_torch.distributed import local_state
    from repro_torch.kernels import reset_launch_counts
    R, R_new, probes = _sharded_case()
    n = R.shape[0]
    card = build_state(torch.as_tensor(R, device="cuda"))
    reset_launch_counts()
    a = onboard_batch_sharded(local_state(card, 0, 1),
                              torch.as_tensor(R_new), probes,
                              s_max=set0_cap(n), maintain=maintain)
    counts = launch_counts()
    assert counts["list_merge"] == (1 if maintain else 0)
    b = onboard_batch_buffered(build_state(torch.as_tensor(R)),
                               torch.as_tensor(R_new), probes,
                               s_max=set0_cap(n), maintain=maintain)
    found = b[2].found
    assert found.any() and (~found).any()
    for name in ("found", "twin_idx", "n_candidates", "overflowed"):
        assert torch.equal(getattr(a[2], name).cpu(), getattr(b[2], name))
    assert lists_match(b[0].numpy(), b[1].numpy(), a[0].cpu().numpy(),
                       a[1].cpu().numpy(), 1e-6) is None
    c = onboard_batch_buffered(card, torch.as_tensor(R_new), probes,
                               s_max=set0_cap(n), maintain=maintain)
    assert torch.equal(a[0], c[0]) and torch.equal(a[1], c[1])
    if maintain:
        assert a[3][0].is_cuda
        assert torch.equal(a[3][0], c[3][0])
        assert torch.equal(a[3][1], c[3][1])
        assert lists_match(b[3][0].numpy(), b[3][1].numpy(),
                           a[3][0].cpu().numpy(), a[3][1].cpu().numpy(),
                           1e-6) is None


def test_sharded_burst_collective_bytes_on_card(nccl1, monkeypatch):
    import torch.distributed as dist
    from repro_torch.core import twinsearch_sharded as tsh
    from repro_torch.distributed import local_state
    R, R_new, probes = _sharded_case()
    n, c = R.shape[0], probes.shape[1]
    seen = []
    for name in ("all_reduce", "all_gather_into_tensor"):
        def counted(t, *a, _fn=getattr(dist, name), **kw):
            seen.append(t.numel() * t.element_size())
            return _fn(t, *a, **kw)
        monkeypatch.setattr(dist, name, counted)
    card = build_state(torch.as_tensor(R, device="cuda"))
    _, _, st = tsh.onboard_batch_sharded(local_state(card, 0, 1),
                                         torch.as_tensor(R_new), probes,
                                         s_max=set0_cap(n))
    branches = ["fallback" if not f else ("base" if t < n else "new")
                for f, t in zip(st.found.tolist(), st.twin_idx.tolist())]
    assert "base" in branches and "fallback" in branches
    assert sum(seen) == sum(tsh.payload_bytes(n, c, b) for b in branches)


def test_resilient_burst_on_card_heals_bit_exact(nccl1):
    from repro_torch.core.twinsearch_sharded import (onboard_batch_resilient,
                                                     onboard_batch_sharded)
    from repro_torch.distributed import local_state
    from repro_torch.serving.guard import RetryPolicy
    R, R_new, probes = _sharded_case()
    n = R.shape[0]
    st = build_state(torch.as_tensor(R, device="cuda"))
    clean = [t.clone() for t in st[:4]]
    want = onboard_batch_sharded(local_state(st, 0, 1),
                                 torch.as_tensor(R_new), probes,
                                 s_max=set0_cap(n))
    replicas = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=2))
    st.sim_vals[5] = float("nan")
    healed, got = onboard_batch_resilient(
        st, torch.as_tensor(R_new), probes, s_max=set0_cap(n),
        replicas=replicas, retry=RetryPolicy(sleep=lambda s: None))
    assert replicas.repaired_rows == 1
    for a, b in zip(healed[:4], clean):
        assert torch.equal(a, b)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m", [(943, 1682), (300, 77), (4100, 257),
                                 (4096, 1682)])
def test_build_step_on_card_matches_plain(cuda, dtype, n, m):
    """The model's build on the similarity kernel against its plain path
    on the CPU: lists within 1e-5, ids except near-ties; sorted across
    more than one row slice at n = 4,100."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import cf
    R = _ratings(np.random.default_rng(n), n, m)
    R[n - 1] = R[2]
    reset_launch_counts()
    cv, ci = cf.build_step(torch.as_tensor(R, device="cuda").to(dtype))
    assert launch_counts()["similarity"] == 1
    pv, pi = cf.build_step(torch.as_tensor(R).to(dtype))
    assert cv.dtype == torch.float32 and ci.dtype == torch.int32
    assert lists_match(pv.numpy(), pi.numpy(), cv.cpu().numpy(),
                       ci.cpu().numpy(), 1e-5) is None


def test_twin_groups_on_card_equal_cpu(cuda):
    from repro_torch.core import twins_graph as tg
    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.integers(0, 300, 2000))
    dst = torch.as_tensor(rng.integers(0, 300, 2000))
    dst[src == 7] = 9
    for n_hash in (1, 4):
        a = tg.adjacency_signature(dst.cuda(), src.cuda(), 300, n_hash)
        b = tg.adjacency_signature(dst, src, 300, n_hash)
        assert torch.equal(a.cpu(), b)
        assert torch.equal(tg.twin_groups(a).cpu(), tg.twin_groups(b))


def test_gaussian_measures_take_card_tensors(cuda):
    from repro_torch.core import gaussian
    rows = torch.rand(4, 500, device="cuda")
    assert gaussian.empirical_max_sublist(rows[0]) == \
        gaussian.empirical_max_sublist(rows[0].cpu().numpy())
    assert gaussian.empirical_set0(rows, rows[:, 3], 0.1) == \
        gaussian.empirical_set0(rows.cpu().numpy(),
                                rows[:, 3].cpu().numpy(), 0.1)


def _tiny_xdeepfm():
    """xDeepFM at the CPU tests' size (``tests/conftest.py::tiny_recsys``),
    from the port's registry."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs._fields import powerlaw_vocabs
    cfg = get_arch("xdeepfm").config
    return dataclasses.replace(
        cfg, field_vocab_sizes=powerlaw_vocabs(39, largest=500, smallest=8,
                                               n_large=2),
        mlp_dims=(64, 64), cin_layers=(16, 16, 16))


@pytest.mark.parametrize("n,hot", [(512, 8), (8192, 8), (33, 5)])
def test_model_embedding_bag_kernel_forward_and_backward(cuda, n, hot):
    """``models.embedding.embedding_bag`` on a CUDA table: its forward is
    one kernel launch, bit for bit the plain version's; its backward
    equals the plain scatter-add of mask·grad within 1e-6 relative to
    max(1, |sum|): both add a row's terms with atomics in no fixed order
    (about 13 terms of up to ~16 a row at 8,192 x 8), so the last bits of
    a sum may differ."""
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import embedding as emb
    rng = np.random.default_rng(n)
    V, dim = 5000, 10
    table = torch.as_tensor(rng.standard_normal((V, dim)).astype(np.float32),
                            device=cuda).requires_grad_()
    idx = torch.as_tensor(rng.integers(0, V, (n, 1, hot)).astype(np.int32),
                          device=cuda)
    mask = torch.as_tensor(rng.random((n, 1, hot)) < 0.6, device=cuda)
    reset_launch_counts()
    out = emb.embedding_bag(table, idx, mask)
    assert launch_counts()["embedding_bag"] == 1
    plain = embedding_bag_ref(table.detach(), idx.reshape(n, hot).long(),
                              mask.reshape(n, hot).float())
    assert torch.equal(out.detach().reshape(n, dim), plain)
    gout = torch.as_tensor(rng.standard_normal((n, 1, dim)).astype(
        np.float32), device=cuda)
    (g,) = torch.autograd.grad(out, table, gout)
    want = torch.zeros((V, dim), device=cuda).index_put_(
        (idx.reshape(-1).long(),),
        (gout.reshape(n, 1, dim) * mask.reshape(n, hot, 1).float()
         ).reshape(-1, dim), accumulate=True)
    assert bool(((g - want).abs()
                 <= 1e-6 * want.abs().clamp_min(1.0)).all())
    with pytest.raises(NotImplementedError):
        emb.embedding_bag(table.detach().double(), idx, mask)


def test_xdeepfm_forward_and_train_step_on_card_match_cpu(cuda):
    """Tiny xDeepFM: the forward on the card (the bag kernel) against the
    CPU plain path within 1e-5; the gradient that ``make_train_step`` hands
    its optimizer (4 microbatches summed, then divided) on the card against
    the CPU's, every leaf within 1e-5 of its largest |value| (AdamW's first
    step moves each weight by about ±lr whatever the gradient's scale, so
    the step alone would not see a wrong scale); and one AdamW step with 4
    microbatches: the loss within 1e-5 and every param within 1e-5."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.data import CTRStream
    from repro_torch.kernels import reset_launch_counts
    from repro_torch.models import recsys as rec
    from repro_torch.training import AdamW, make_train_step
    from repro_torch.tree import leaves, tree_map
    cfg = _tiny_xdeepfm()
    params = rec.init_params(torch.Generator().manual_seed(0), cfg)
    batch = CTRStream(cfg, 64, seed=3)(0)
    card_p = tree_map(lambda t: t.to(cuda), params)
    cb = {k: torch.as_tensor(v, device=cuda) for k, v in batch.items()}
    hb = {k: torch.as_tensor(v) for k, v in batch.items()}
    reset_launch_counts()
    with torch.no_grad():
        got = rec.forward(card_p, cb, cfg)
    assert launch_counts()["embedding_bag"] == 1
    want = rec.forward(params, hb, cfg)
    assert float((got.cpu() - want).abs().max()) <= 1e-5

    class Keep:
        """An optimizer that keeps the gradient it is given."""

        def init(self, p):
            return None

        def update(self, grads, state, p):
            self.grads = params_to_numpy(grads)
            return p, state

    kept = []
    for p, b in ((card_p, cb), (params, hb)):
        keep = Keep()
        make_train_step(lambda p, b: rec.loss(p, b, cfg), keep,
                        accum_steps=4)(p, None, None, b)
        kept.append(leaves(keep.grads))
    for a, b in zip(*kept):
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()

    opt = AdamW(lr=1e-3, weight_decay=0.01)
    step = make_train_step(lambda p, b: rec.loss(p, b, cfg), opt,
                           accum_steps=4)
    reset_launch_counts()
    cp, _, _, cm = step(card_p, opt.init(card_p), None, cb)
    assert launch_counts()["embedding_bag"] == 4
    hp, _, _, hm = step(params, opt.init(params), None, hb)
    assert abs(float(cm["loss"]) - float(hm["loss"])) <= 1e-5
    for a, b in zip(leaves(params_to_numpy(cp)), leaves(params_to_numpy(hp))):
        assert np.abs(a - b).max() <= 1e-5


# ---------------------------------------------------------------------------
# The LM family: tiny configs, the card against the CPU
# ---------------------------------------------------------------------------

LM_ARCHS = ("gemma3-1b", "gemma-7b", "granite-20b", "olmoe-1b-7b",
            "llama4-scout-17b-a16e")


def _tiny_lm(arch: str, dtype: str):
    """The family structure of ``arch`` at tiny widths (the shrink of
    ``tests/conftest.py::tiny_lm``, which this file cannot import)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MoEConfig
    cfg = get_arch(arch).config
    unit = cfg.global_every or 1
    n_kv = 1 if cfg.n_kv_heads == 1 else (
        4 if cfg.n_kv_heads == cfg.n_heads else 2)
    moe = None if cfg.moe is None else MoEConfig(
        n_experts=4, top_k=min(2, cfg.moe.top_k), d_ff_expert=64,
        n_shared=cfg.moe.n_shared)
    return dataclasses.replace(
        cfg, n_layers=max(2, 2 * unit) if unit > 1 else 2, d_model=64,
        n_heads=4, n_kv_heads=n_kv, head_dim=16, d_ff=128, vocab_size=512,
        moe=moe, window=(8 if cfg.window is not None else None),
        dtype=dtype)


def _lm_close(got, want, dtype, grad: bool = False) -> bool:
    """float32: within 1e-5 of the largest |want| (TF32 is off, so only
    the order of float32 sums differs), 1e-4 for a gradient (the bound of
    ``tests/test_torch_transformer.py``: the router's tiny gradients pass
    through the gates' renormalisation); bfloat16: the RMS of the
    difference within 1/16 of the RMS of ``want``, 1/4 for a gradient
    (bf16 roundings differ between cuBLAS and the CPU, and near-tied
    routing may flip)."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    if dtype == "float32":
        return float((got - want).abs().max()) <= \
            (1e-4 if grad else 1e-5) * float(want.abs().max())
    rms = lambda t: float(t.square().mean().sqrt())         # noqa: E731
    return rms(got - want) <= rms(want) * (1 / 4 if grad else 1 / 16)


@pytest.mark.parametrize("shape", [(64, 96, 80), (3, 40, 64, 24)])
def test_matmul_f32_on_card_matches_float32_copies(cuda, shape):
    """``layers.matmul_f32`` of bf16 operands on the card (cuBLAS with a
    float32 output) against the product of float32 copies on the CPU:
    within 1e-6 relative (each product exact, float32 sums in another
    order); and its gradients, float32 products cast to bf16, equal the
    CPU's within one bf16 ulp."""
    from repro_torch.models.layers import matmul_f32
    rng = np.random.default_rng(len(shape))
    *batch, m, k, n = shape
    a = torch.tensor(rng.standard_normal((*batch, m, k)),
                     dtype=torch.bfloat16)
    b = torch.tensor(rng.standard_normal((*batch, k, n)),
                     dtype=torch.bfloat16)
    want = torch.matmul(a.float(), b.float())
    ca = a.to(cuda).requires_grad_()
    cb = b.to(cuda).requires_grad_()
    got = matmul_f32(ca, cb)
    assert got.dtype == torch.float32
    assert float((got.detach().cpu() - want).abs().max()) <= \
        1e-6 * float(want.abs().max())
    g = torch.tensor(rng.standard_normal(want.shape), dtype=torch.float32)
    ga, gb = torch.autograd.grad(got, (ca, cb), g.to(cuda))
    ha, hb = a.clone().requires_grad_(), b.clone().requires_grad_()
    wa, wb = torch.autograd.grad(matmul_f32(ha, hb), (ha, hb), g)
    for x, y in ((ga, wa), (gb, wb)):
        assert x.dtype == torch.bfloat16
        assert float((x.cpu().float() - y.float()).abs().max()) <= \
            float(y.float().abs().max()) * 2 ** -7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_forward_and_loss_on_card_match_cpu(cuda, arch, dtype):
    """``forward`` and ``lm_loss`` with its gradients, the same weights on
    the card and on the CPU (tolerances of ``_lm_close``; the loss within
    1e-5 relative in float32, 1e-2 in bfloat16)."""
    from repro_torch.models import transformer as tlm
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.tree import leaves, tree_map
    cfg = _tiny_lm(arch, dtype)
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    card = tree_map(lambda t: t.to(cuda), params)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        h, aux = tlm.forward(card, tokens.to(cuda), cfg)
        wh, waux = tlm.forward(params, tokens, cfg)
    assert _lm_close(h, wh, dtype)

    def loss_fn(p, t):
        return tlm.lm_loss(p, t, cfg, loss_chunk=8)
    loss, g = value_and_grad(loss_fn, card, tokens.to(cuda))
    wloss, wg = value_and_grad(loss_fn, params, tokens)
    rel = 1e-5 if dtype == "float32" else 1e-2
    assert abs(float(loss) - float(wloss)) <= rel * abs(float(wloss))
    for a, b in zip(leaves(g), leaves(wg)):
        if b.abs().max() > 0:
            assert _lm_close(a, b, dtype, grad=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,shared", [("swiglu", False), ("geglu", True),
                                        ("gelu", False)])
def test_moe_ffn_on_card_matches_cpu(cuda, act, shared, dtype):
    """``moe_ffn`` at capacity factor 0.5 (choices dropped) on the card
    against the CPU: the same routing (float32 router logits), ``y`` by
    ``_lm_close`` and ``aux`` within 1e-6."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import moe_ffn
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                    n_shared=int(shared), capacity_factor=0.5)
    g = torch.Generator().manual_seed(4)
    gf = 2 if act in ("swiglu", "geglu") else 1
    dt = getattr(torch, dtype)

    def w(*shape):
        return (torch.randn(shape, generator=g) * shape[-2] ** -0.5).to(dt)
    x = torch.randn((4, 32, 64), generator=g).to(dt)
    router = torch.randn((64, 8), generator=g) * 0.125
    w_in, w_out = w(8, 64, gf * 32), w(8, 32, 64)
    sh = (w(64, gf * 32), w(32, 64)) if shared else None
    y, aux = moe_ffn(x, router, w_in, w_out, sh, cfg, act, group_size=64)
    cy, caux = moe_ffn(x.to(cuda), router.to(cuda), w_in.to(cuda),
                       w_out.to(cuda),
                       None if sh is None else tuple(t.to(cuda) for t in sh),
                       cfg, act, group_size=64)
    assert _lm_close(cy, y, dtype)
    assert abs(float(caux) - float(aux)) <= 1e-6


def test_chunked_attention_on_card_matches_cpu(cuda):
    """``gqa_attention`` on the chunked path (chunk 8, window 4: wholly
    masked chunks) in bf16 and float32, card against CPU."""
    from repro_torch.models.attention import gqa_attention
    g = torch.Generator().manual_seed(5)
    pos = torch.arange(64, dtype=torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(s, generator=g).to(dt) for s in
                   ((2, 64, 4, 16), (2, 64, 1, 16), (2, 64, 1, 16)))
        want = gqa_attention(q, k, v, pos, pos, window=4, chunk=8)
        got = gqa_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                            pos.to(cuda), pos.to(cuda), window=4, chunk=8)
        assert torch.isfinite(got.float()).all()
        assert _lm_close(got, want, str(dt).removeprefix("torch."))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_generate_on_card_matches_cpu(cuda, arch):
    """``LMServer.generate`` in float32 on the card and on the CPU with the
    same weights: equal completions and info, dedup on and off (prompts of
    12 tokens: the ring full; of 4 for gemma3-1b: its negative positions)."""
    from repro_torch.models import transformer as tlm
    from repro_torch.serving import LMServer
    from repro_torch.tree import tree_map
    cfg = _tiny_lm(arch, "float32")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    card = LMServer(tree_map(lambda t: t.to(cuda), params), cfg, max_len=32)
    host = LMServer(params, cfg, max_len=32)
    assert card.device.type == "cuda" and host.device.type == "cpu"
    rng = np.random.default_rng(0)
    for S in ((12, 4) if cfg.window else (12,)):
        prompts = rng.integers(0, cfg.vocab_size, (3, S)).astype(np.int32)
        batch = prompts[[0, 1, 0, 2, 1]]
        for dedup in (True, False):
            got, info = card.generate(batch, n_new=6, dedup=dedup)
            want, winfo = host.generate(batch, n_new=6, dedup=dedup)
            assert info == winfo
            assert np.array_equal(got, want), (S, dedup)


# ---------------------------------------------------------------------------
# The GNN family: small graphs, the card against the CPU plain path
# ---------------------------------------------------------------------------

GNN_OUT_RTOL, GNN_LOSS_RTOL, GNN_GRAD_RTOL = 1e-5, 1e-5, 1e-4


def _gnn_cfg():
    from repro_torch.configs import get_arch
    return get_arch("gat-cora").config


def _gnn_graph(n=300, e=1500, d=24, seed=31) -> dict:
    """A random graph with self-loops; the last node has no in-edges."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n, e), np.arange(n - 1)])
    dst = np.concatenate([rng.integers(0, n - 1, e), np.arange(n - 1)])
    return {"feats": rng.normal(size=(n, d)).astype(np.float32),
            "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32),
            "labels": rng.integers(0, 7, n).astype(np.int32),
            "mask": rng.random(n) < 0.5}


def _gnn_batch(kind: str) -> tuple[dict, int, int]:
    """(numpy batch, d_feat, n_out) of a small ``kind`` step."""
    rng = np.random.default_rng(32)
    if kind == "train_full":
        return _gnn_graph(), 24, 7
    if kind == "train_sampled":
        n, B, f1, f2 = 500, 64, 5, 4
        return {"feats": rng.normal(size=(n, 24)).astype(np.float32),
                "roots": rng.choice(n, B, replace=False).astype(np.int32),
                "nbr1": rng.integers(0, n, (B, f1)).astype(np.int32),
                "nbr2": rng.integers(0, n, (B * (1 + f1), f2)).astype(
                    np.int32),
                "labels": rng.integers(0, 41, B).astype(np.int32)}, 24, 41
    from repro_torch.data import molecule_batch
    return molecule_batch(0, batch=32, n_nodes=12, n_edges=20,
                          d_feat=16), 16, 2


def _gnn_close(got, want, rtol) -> bool:
    got, want = got.detach().float().cpu(), want.detach().float()
    return float((got - want).abs().max()) <= rtol * float(
        want.abs().max())


@pytest.mark.parametrize("concat", [True, False])
def test_gat_layers_on_card_match_cpu(cuda, concat):
    """``gat_layer_segment`` (a node with no in-edges included) and
    ``gat_layer_fanout`` on the card against the CPU."""
    from repro_torch.models import gnn
    from repro_torch.tree import tree_map
    g = _gnn_graph()
    lp = gnn.init_params(torch.Generator().manual_seed(3), _gnn_cfg(),
                         24)["l1"]
    lpc = tree_map(lambda t: t.to(cuda), lp)
    x, src, dst = (torch.as_tensor(g[k]) for k in
                   ("feats", "edge_src", "edge_dst"))
    want = gnn.gat_layer_segment(x, src, dst, lp, 8, concat=concat)
    got = gnn.gat_layer_segment(x.to(cuda), src.to(cuda), dst.to(cuda),
                                lpc, 8, concat=concat)
    assert not want[-1].any() and not got[-1].any()
    assert _gnn_close(got, want, GNN_OUT_RTOL)
    xs, xn = x[:40], x[40:240].reshape(40, 5, 24)
    want = gnn.gat_layer_fanout(xs, xn, lp, 8, concat=concat)
    got = gnn.gat_layer_fanout(xs.to(cuda), xn.to(cuda), lpc, 8,
                               concat=concat)
    assert _gnn_close(got, want, GNN_OUT_RTOL)


@pytest.mark.parametrize("kind", ["train_full", "train_sampled",
                                  "train_batched"])
def test_gnn_losses_and_grads_on_card_match_cpu(cuda, kind):
    """Each loss of ``LOSS_BY_KIND`` and every gradient leaf, card against
    CPU, from the same weights and inputs."""
    from repro_torch.models import gnn
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.tree import leaves, tree_map
    batch, d, n_out = _gnn_batch(kind)
    cfg = _gnn_cfg()
    params = gnn.init_params(torch.Generator().manual_seed(4), cfg, d, n_out)
    fn = gnn.LOSS_BY_KIND[kind]
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    want, wg = value_and_grad(lambda p, b: fn(p, b, cfg), params, tb)
    got, gg = value_and_grad(lambda p, b: fn(p, b, cfg),
                             tree_map(lambda t: t.to(cuda), params),
                             {k: v.to(cuda) for k, v in tb.items()})
    assert abs(float(got) - float(want)) <= GNN_LOSS_RTOL * abs(float(want))
    for a, b in zip(leaves(gg), leaves(wg)):
        assert a.is_cuda and _gnn_close(a, b, GNN_GRAD_RTOL)


def test_edge_parallel_gat_on_card_matches_plain_cpu(nccl1, monkeypatch):
    """``gnn_ep.loss_full_ep`` on a one-rank NCCL group, its message sum in
    chunks of 97 edges (1,799 edges: none divides them), against the plain
    ``gnn.loss_full`` on the CPU: the loss and every gradient leaf."""
    from repro_torch.models import gnn, gnn_ep
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.tree import leaves, tree_map
    cfg = _gnn_cfg()
    batch, d, n_out = _gnn_batch("train_full")
    params = gnn.init_params(torch.Generator().manual_seed(5), cfg, d, n_out)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    want, wg = value_and_grad(lambda p, b: gnn.loss_full(p, b, cfg), params,
                              tb)
    monkeypatch.setattr(gnn_ep, "MSG_CHUNK_BYTES", 97 * 8 * 8 * 4)
    info = gnn_ep.GNNEPInfo()
    got, gg = value_and_grad(
        lambda p, b: gnn_ep.loss_full_ep(p, b, cfg, info),
        tree_map(lambda t: t.to(nccl1), params),
        {k: v.to(nccl1) for k, v in tb.items()})
    assert abs(float(got) - float(want)) <= GNN_LOSS_RTOL * abs(float(want))
    for a, b in zip(leaves(gg), leaves(wg)):
        assert a.is_cuda and _gnn_close(a, b, GNN_GRAD_RTOL)


# ---------------------------------------------------------------------------
# Expert parallelism (models.moe_ep) on a one-rank NCCL group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_ep_on_card_matches_moe_ffn(nccl1, dtype):
    """``moe_ffn_ep`` on a (1, 1) mesh over a one-rank NCCL group against
    ``moe_ffn`` on the card at a capacity where nothing drops (capacity
    factor E/k: every expert may take every token): ``y``, the aux loss and
    the gradients of x, router, w_in and w_out by ``_lm_close``."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_ep import MoEEPInfo, moe_ffn_ep
    cfg = MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                    capacity_factor=4.0)
    g = torch.Generator().manual_seed(6)
    dt = getattr(torch, dtype)

    def w(*shape):
        return (torch.randn(shape, generator=g) * shape[-2] ** -0.5).to(dt)
    ins = [torch.randn((2, 64, 64), generator=g).to(dt),
           torch.randn((64, 8), generator=g) * 0.125,
           w(8, 64, 64), w(8, 32, 64)]
    ct = torch.randn((2, 64, 64), generator=g).to(nccl1).to(dt)
    mesh = make_mesh((1, 1), ("data", "model"))
    info = MoEEPInfo(dp=("data",), mp="model", mp_size=1,
                     win_spec=P("model", None, "data"),
                     wout_spec=P("model", None, "data"),
                     acts_spec=P("data", None, None), mesh=mesh)
    outs = []
    for fn in (lambda *a: moe_ffn(a[0], a[1], a[2], a[3], None, cfg,
                                  "swiglu", group_size=128),
               lambda *a: moe_ffn_ep(*a, cfg, "swiglu", info)):
        leaves_ = [t.to(nccl1).requires_grad_() for t in ins]
        y, aux = fn(*leaves_)
        grads = torch.autograd.grad((y.float() * ct.float()).sum() + aux,
                                    leaves_)
        outs.append((y, aux, grads))
    (wy, waux, wg), (y, aux, gr) = outs
    assert y.is_cuda and _lm_close(y, wy, dtype)
    assert abs(float(aux.detach()) - float(waux.detach())) <= \
        1e-5 * abs(float(waux.detach()))
    for a, b in zip(gr, wg):
        assert _lm_close(a, b, dtype, grad=True)


def test_olmoe_prefill_cell_through_moe_ep_on_card(nccl1, monkeypatch):
    """A tiny OLMoE prefill cell through ``build_cell`` on a (1, 1) mesh of
    the card: every layer takes ``moe_ffn_ep``, and at a capacity where
    nothing drops the logits and cache equal ``prefill`` without the hook
    (``moe_ffn``) on the CPU, by ``_lm_close``."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as tlm
    from repro_torch.tree import tree_map
    cfg = _tiny_lm("olmoe-1b-7b", "float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    spec = dataclasses.replace(get_arch("olmoe-1b-7b"), config=cfg)
    shape = ShapeSpec("p", "prefill", {"seq_len": 32, "global_batch": 2})
    calls = []
    real = tlm.moe_ffn_ep
    monkeypatch.setattr(tlm, "moe_ffn_ep",
                        lambda *a: calls.append(1) or real(*a))
    cell = steps.build_cell(spec, shape, make_mesh((1, 1),
                                                   ("data", "model")))
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 32), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, cache = cell.fn(tree_map(lambda t: t.to(nccl1), params),
                                {"tokens": tokens.to(nccl1)})
        wlogits, wcache = tlm.prefill(params, tokens, cfg)
    assert len(calls) == cfg.n_layers
    assert _lm_close(logits, wlogits, "float32")
    for k in wcache:
        if k == "ring_pos":
            assert torch.equal(cache[k].cpu(), wcache[k])
        else:
            assert _lm_close(cache[k], wcache[k], "float32"), k


# ---------------------------------------------------------------------------
# The kernels under the cost counter (launch.trace.Counter): on the card each
# reports the formula it reports on ``meta``, still launches once, and gives
# the bits it gives without a counter
# ---------------------------------------------------------------------------

def _counted_case(name, rng):
    """(wrapper, its CPU arguments) at small shapes."""
    def f32(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)

    if name == "similarity":
        return cosine_similarity, (f32(37, 300), f32(451, 300))
    if name == "list_merge":
        vals = torch.sort(f32(16, 64), dim=1).values
        idx = torch.as_tensor(rng.integers(0, 64, (16, 64)), dtype=torch.int32)
        mask = torch.as_tensor(rng.random((16, 3)) < 0.8)
        return merge_insert, (vals, idx, f32(16, 3),
                              torch.arange(3, dtype=torch.int32), mask)
    if name == "list_merge.rows":
        vals = torch.sort(f32(16, 64), dim=1).values
        idx = torch.as_tensor(rng.integers(0, 70, (16, 64)), dtype=torch.int32)

        def rows(vals, idx, U, ids):              # rows 0, 1, 14, 15 stay 0
            out_v = torch.zeros((16, 70), device=vals.device)
            out_i = torch.zeros((16, 70), dtype=torch.int32,
                                device=vals.device)
            return merge_rows(vals, idx, U, ids, slice(2, 14), out_v, out_i,
                              n_base=60)
        return rows, (vals, idx, f32(3, 16),
                      torch.arange(60, 63, dtype=torch.int32))
    if name == "verify_rows.live":
        def live(vals, ratings, norms):          # rows 27-29 not live
            return live_rows_ok(vals, ratings, norms, 27)
        return live, (torch.sort(f32(30, 45), dim=1).values, f32(30, 61),
                      f32(30).abs())
    if name == "knn_score":
        return knn_scores, (f32(120, 40), f32(33, 20).clamp_min(0),
                            torch.as_tensor(rng.integers(0, 120, (33, 20))),
                            torch.as_tensor(rng.integers(0, 120, (33,))))
    if name == "twin_probe":
        rows = f32(8, 700)
        return twin_probe, (rows, rows[:, 9].clone())
    if name == "verify_rows":
        C = f32(37, 211)
        return verify_rows, (C, C[3].clone(),
                             torch.as_tensor(rng.random(37) < 0.9))
    return embedding_bag, (f32(50, 8), torch.as_tensor(
        rng.integers(0, 50, (4, 2)), dtype=torch.int32), None,
        torch.as_tensor(rng.random((4, 2)) < 0.6))


@pytest.mark.parametrize("name", ["similarity", "list_merge",
                                  "list_merge.rows", "knn_score",
                                  "twin_probe", "verify_rows",
                                  "verify_rows.live", "embedding_bag"])
def test_kernel_counts_on_card_what_it_counts_on_meta(cuda, name):
    """``<kernel>.<entry>`` names a second entry point of a kernel."""
    from repro_torch.launch.trace import Counter

    def on(device, args):
        return [None if a is None else a.to(device) for a in args]

    kernel = name.split(".")[0]
    fn, args = _counted_case(name, np.random.default_rng(7))
    card_args = on(cuda, args)
    plain = fn(*card_args)                 # no counter (and warm state)
    torch.cuda.synchronize()
    with Counter() as card:
        out = _launched(kernel, fn, *card_args)
    meta_args = on("meta", args)
    with Counter() as meta:
        fn(*meta_args)
    assert card.kernels == meta.kernels
    assert card.kernels[kernel]["calls"] == 1
    assert (card.flops, card.flops_f32, card.bytes) == (
        meta.flops, meta.flops_f32, meta.bytes)
    outs = out if isinstance(out, tuple) else (out,)
    plains = plain if isinstance(plain, tuple) else (plain,)
    for o, p in zip(outs, plains):
        assert _same_bits(o, p) if o.is_floating_point() else \
            torch.equal(o, p)
