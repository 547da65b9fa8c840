"""The read path's twin dedup on the CPU: ``kernels.key_dedup``'s plain
version (``ref.py``) and ``cf_server.plan_of_first`` give the plan that
``serving.dedup.dedup_rows`` gives over the same keys copied to the host.

Keys are (top-k sims, neighbour ids, a rating row gathered by user id) as
``recommend_batch`` builds them, and (sims, ids, item) as
``predict_batch`` does, with planted twins: repeated users, other users
with the same key, and near-twins that differ only in their last word, at
a -0.0 / 0.0 or a NaN payload.  The hashes are held to an independent
numpy computation of the same formula (the card tests hold the kernel's
hashes to ``ref.py``'s bit for bit), and a verify fed all-equal hashes
must still keep distinct keys apart.  The kernel itself is held to these
on the card in ``test_torch_gpu.py``, which holds the cases (that file
imports nothing of the test package, which the card's machine may
shadow).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import launch_counts
from repro_torch.kernels.key_dedup import ops as key_dedup
from repro_torch.kernels.key_dedup.kernel import probe_cuda, verify_cuda
from repro_torch.kernels.key_dedup.ref import key_words, probe_ref, verify_ref
from repro_torch.serving.cf_server import plan_of_first
from repro_torch.serving.dedup import dedup_rows
from tests.test_torch_gpu import assert_same_plan, dedup_case, host_keys

torch.set_num_threads(2)

DOUBAN_ITEMS = 58_541


def numpy_hashes(words: np.ndarray) -> np.ndarray:
    """The probe's formula in uint64, apart from ``ref.py``."""
    w = words.view(np.uint32).astype(np.uint64)
    x = (np.arange(w.shape[1], dtype=np.uint64) << np.uint64(32)) | w
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
        return x.sum(axis=1, dtype=np.uint64).view(np.int64)


@pytest.mark.parametrize("B,k,N,m", [(1, 20, 30, 57), (7, 3, 20, 1001),
                                     (32, 20, 40, DOUBAN_ITEMS),
                                     (64, 7, 50, 333), (256, 20, 60, 129)])
@pytest.mark.parametrize("kind", ["recommend", "predict"])
def test_plain_plan_is_dedup_rows_plan(B, k, N, m, kind):
    sims, nbrs, R, users = dedup_case(np.random.default_rng(B * m + k),
                                      B, k, N, m)
    if kind == "recommend":
        key, third = (sims, nbrs, R, users), R[users]
    else:
        items = (users % 3).to(torch.int32).view(-1, 1)
        key, third = (sims, nbrs, items, None), items
    before = launch_counts()["key_dedup"]
    hashes = key_dedup.probe(*key)
    plan = plan_of_first(key_dedup.verify(*key, hashes))
    assert launch_counts()["key_dedup"] == before       # plain version ran
    keys = host_keys(sims, nbrs, third)
    assert_same_plan(plan, dedup_rows(keys))
    assert np.array_equal(hashes.numpy(), numpy_hashes(keys))
    if kind == "recommend" and B >= 4:
        # the planted near-twins stay apart, the planted twin is shared
        first = {int(u): plan.scatter[i] for i, u in enumerate(users)}
        assert first[0] == first[1]
        assert len({first[0], first[2], first[3]}) == 3


@pytest.mark.parametrize("B,m", [(9, 40), (32, 1001)])
def test_plain_verify_keeps_distinct_keys_apart_under_collisions(B, m):
    """All hashes equal: every earlier key is compared, and only equal
    ones are shared (the plan ``dedup_rows`` gives with its probe forced
    to collide)."""
    sims, nbrs, R, users = dedup_case(np.random.default_rng(m), B, 5, 20, m)
    words = key_words(sims, nbrs, R, users)
    first = verify_ref(words, torch.zeros(B, dtype=torch.int64))
    assert_same_plan(plan_of_first(first),
                     dedup_rows(host_keys(sims, nbrs, R[users])))
    assert torch.equal(first, verify_ref(words, probe_ref(words)))


def test_signed_zero_and_nan_payloads_are_not_shared():
    """Bitwise keys: -0.0 is not 0.0, and NaNs with other payloads differ;
    the same NaN bits are shared."""
    bits = np.array([0x00000000, 0x80000000, 0x7FC00000, 0x7FC00001,
                     0x7FC00000, 0x00000000], np.uint32)
    sims = torch.as_tensor(bits.view(np.float32).reshape(-1, 1).copy())
    nbrs = torch.zeros((6, 2), dtype=torch.int32)
    rows = torch.ones((6, 3))
    plan = plan_of_first(key_dedup.first_twins(sims, nbrs, rows))
    assert plan.unique_rows.tolist() == [0, 1, 2, 3]
    assert plan.scatter.tolist() == [0, 1, 2, 3, 2, 0]
    assert_same_plan(plan, dedup_rows(host_keys(sims, nbrs, rows)))


def test_key_words_read_strided_segments_and_gathered_rows():
    """The sims of a top-k are a column slice of a wider sort; the rows
    are gathered by user id, in the order given."""
    wide = torch.arange(24, dtype=torch.float32).view(3, 8)
    nbrs = torch.arange(6, dtype=torch.int32).view(3, 2)
    R = torch.arange(20, dtype=torch.float32).view(5, 4)
    users = torch.tensor([4, 0, 4])
    words = key_words(wide[:, :3], nbrs, R, users)
    want = torch.cat([wide[:, :3].view(torch.int32), nbrs,
                      R[[4, 0, 4]].view(torch.int32)], dim=1)
    assert torch.equal(words, want)
    plan = plan_of_first(key_dedup.first_twins(wide[:, :3], nbrs, R, users))
    assert plan.n_unique == 3


@pytest.mark.parametrize("case", ["dtype", "shape", "rows", "stride",
                                  "hashes"])
def test_bindings_check_their_key_on_meta(case):
    """The bindings refuse what the kernel does not read: segments of
    other than 4-byte words, mismatched batches, a non-int64 row index, a
    column stride, hashes of the wrong shape or type."""
    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    key = [meta((4, 3)), meta((4, 3), torch.int32), meta((9, 5)),
           meta((4,), torch.int64)]
    hashes = meta((4,), torch.int64)
    err = ValueError
    if case == "dtype":
        key[0], err = meta((4, 3), torch.bfloat16), TypeError
    elif case == "shape":
        key[1] = meta((5, 3), torch.int32)
    elif case == "rows":
        key[3], err = meta((4,), torch.int32), TypeError
    elif case == "stride":
        key[2] = meta((5, 9)).t()
    else:
        hashes = meta((4,), torch.int32)
    if case != "hashes":
        with pytest.raises(err):
            probe_cuda(*key)
    with pytest.raises(err):
        verify_cuda(*key, hashes)


def test_meta_outputs_and_no_launch():
    key = (torch.empty((6, 4), device="meta"),
           torch.empty((6, 4), dtype=torch.int32, device="meta"),
           torch.empty((6, 1), dtype=torch.int32, device="meta"), None)
    before = launch_counts()["key_dedup"]
    hashes = key_dedup.probe(*key)
    first = key_dedup.verify(*key, hashes)
    assert (hashes.shape, hashes.dtype, first.shape, first.dtype) == (
        (6,), torch.int64, (6,), torch.int32)
    assert hashes.is_meta and first.is_meta
    assert launch_counts()["key_dedup"] == before
