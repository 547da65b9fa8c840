"""The port's roofline (``repro_torch.launch.roofline``) against the
reference's, the kernels' cost formulas against the bounds ``PERF.md`` §6
gives at the smoke shapes, and the kernels' ``meta`` branches under the
counter of ``repro_torch.launch.trace``."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.launch import roofline as jroof
from repro_torch.kernels import _lib
from repro_torch.kernels.embedding_bag import kernel as bag_k
from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.knn_score import kernel as knn_k
from repro_torch.kernels.knn_score.ops import knn_scores
from repro_torch.kernels.list_merge import kernel as merge_k
from repro_torch.kernels.list_merge.ops import merge_insert
from repro_torch.kernels.similarity import kernel as sim_k
from repro_torch.kernels.similarity.ops import cosine_similarity
from repro_torch.kernels.twin_probe import kernel as probe_k
from repro_torch.kernels.twin_probe.ops import twin_probe
from repro_torch.kernels.verify_rows import kernel as verify_k
from repro_torch.kernels.verify_rows.ops import verify_rows
from repro_torch.launch import roofline
from repro_torch.launch.trace import Collectives, Counter

torch.set_num_threads(2)

# Collective lines as XLA prints them: plain and tuple results, async
# start/done pairs (counted once), layouts, and an op that is no collective.
HLO = """
  %ag = bf16[16,2048]{1,0} all-gather(bf16[1,2048]{1,0} %p), dimensions={0}
  %ar.1 = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x), to_apply=%sum
  %ars = f32[] all-reduce-start(f32[] %y), to_apply=%sum
  %ard = f32[] all-reduce-done(f32[] %ars)
  %a2a = (f32[320,128]{1,0}, f32[320,128]{1,0}) all-to-all(%a, %b)
  %rs = f32[2,64,32]{1,0,2} reduce-scatter(f32[2,128,32] %g), dimensions={1}
  %cp = s32[4]{0} collective-permute(s32[4]{0} %i), source_target_pairs={{0,1}}
  %dot = f32[8,8]{1,0} dot(f32[8,4] %a, f32[4,8] %b)
"""


def test_collective_census_matches_reference():
    assert roofline.collective_census(HLO) == jroof.collective_census(HLO)
    assert roofline.collective_census(HLO)["all-reduce"] == {"count": 2,
                                                             "bytes": 4100}


def test_port_census_reads_the_recorded_collectives():
    rec = Collectives()
    rec.record("all-to-all", (640, 128), torch.bfloat16, 2, count=3)
    rec.record("all-reduce", (), torch.float32, 8)
    rec.record("all-gather", (4, 4), torch.float32, 1)   # one rank: none
    text = rec.hlo_text()
    assert roofline.collective_census(text) == jroof.collective_census(
        text) == {"all-to-all": {"count": 3, "bytes": 3 * 640 * 128 * 2},
                  "all-reduce": {"count": 1, "bytes": 4}}


def test_roofline_terms_keys_match_reference():
    t = roofline.RooflineTerms(1.0, 2.0, 3.0)
    j = jroof.RooflineTerms(1.0, 2.0, 3.0)
    assert list(t.as_dict()) == list(j.as_dict())
    jfields = [f.name for f in dataclasses.fields(jroof.RooflineTerms)]
    assert [f.name for f in dataclasses.fields(
        roofline.RooflineTerms)][:len(jfields)] == jfields


@pytest.mark.parametrize("flops,bytes_hbm,bytes_coll,model", [
    (1e15, 1e12, 1e9, 5e14), (1e9, 1e12, 0.0, 0.0), (0.0, 0.0, 1e11, 1.0)])
def test_terms_are_the_reference_formula_at_the_h100_rates(
        flops, bytes_hbm, bytes_coll, model):
    t = roofline.RooflineTerms(flops, bytes_hbm, bytes_coll, model,
                               {"all-reduce": {"count": 1, "bytes": 4}})
    assert t.t_compute == flops / roofline.PEAK_FLOPS
    assert t.t_memory == bytes_hbm / roofline.HBM_BW
    assert t.t_collective == bytes_coll / roofline.ICI_BW
    assert t.bound_time == max(t.t_compute, t.t_memory, t.t_collective)
    assert t.useful_fraction == (model / flops if flops > 0 else 0.0)
    # The reference's own arithmetic with the port's constants.
    with pytest.MonkeyPatch.context() as mp:
        for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
            mp.setattr(jroof, name, getattr(roofline, name))
        j = jroof.RooflineTerms(flops, bytes_hbm, bytes_coll, model,
                                {"all-reduce": {"count": 1, "bytes": 4}})
        assert t.as_dict() == j.as_dict()
    assert (roofline.PEAK_FLOPS, roofline.PEAK_FLOPS_F32, roofline.HBM_BW,
            roofline.ICI_BW) == (989e12, 67e12, 3.35e12, 450e9)


def test_fp32_flops_take_the_fp32_rate():
    t = roofline.RooflineTerms(3e12, 0.0, 0.0, flops_f32=1e12)
    assert t.t_compute == pytest.approx(2e12 / 989e12 + 1e12 / 67e12)
    assert t.as_dict()["flops_per_device"] == 3e12


def test_analyze_reads_cost_and_text():
    class Stub:
        def cost_analysis(self):
            return {"flops": 8.0, "flops f32": 2.0, "bytes accessed": 16.0}

        def as_text(self):
            return HLO
    t = roofline.analyze(Stub(), 4.0)
    assert (t.flops, t.flops_f32, t.bytes_hbm, t.model_flops) == (
        8.0, 2.0, 16.0, 4.0)
    assert t.collectives == jroof.collective_census(HLO)
    assert t.bytes_coll == sum(v["bytes"] for v in t.collectives.values())


# ---------------------------------------------------------------------------
# The kernels' cost formulas: the Bound column of PERF.md §6 at the smoke
# shapes (chip_smoke.py phases 3 and 5)
# ---------------------------------------------------------------------------

COSTS = {
    # nq = 64 against the (32,832, 58,541) arena: 2.46e11 FLOP.
    "similarity": (sim_k.cost(64, 32_832, 58_541, torch.float32),
                   "flops", 2.46e11, 3),
    # (32,768, 32,896) lists, k = 64: 17.3 GB.
    "list_merge": (merge_k.cost(32_768, 32_896, 64), "bytes", 17.3e9, 3),
    # B = 256, k = 20, m = 58,541, 4,959 distinct rows: 1.22 GB.
    "knn_score": (knn_k.cost(32_832, 58_541, 256, 20, rows=4_959), "bytes",
                  1.22e9, 3),
    # (458, 58,541) f32 candidate block: 107.5 MB.
    "verify_rows": (verify_k.cost(458, 58_541, torch.float32), "bytes",
                    107.5e6, 4),
    # (8, 32,896) probe rows: 1.09 MB.
    "twin_probe": (probe_k.cost(8, 32_896), "bytes", 1.09e6, 3),
    # 262,144 bags x 8, f32 weights, 100,194 distinct rows of 10: 31.3 MB.
    "embedding_bag": (bag_k.cost(60_803_072, 262_144, 8, 10, weighted=True,
                                 masked=False, rows=100_194), "bytes",
                      31.3e6, 3),
}


@pytest.mark.parametrize("name", sorted(COSTS))
def test_cost_formula_reproduces_the_perf_bound(name):
    cost, field, want, digits = COSTS[name]
    got = getattr(cost, field)
    assert float(f"{got:.{digits}g}") == want, (name, got)


def test_build_cost_is_the_bf16_tensor_core_bound():
    c = sim_k.cost(32_768, 32_768, 58_541, torch.bfloat16)
    assert c.flops == 2 * 32_768 ** 2 * 58_541 and not c.fp32
    assert c.flops / 989e12 * 1e3 == pytest.approx(127.1, abs=0.05)


# ---------------------------------------------------------------------------
# The meta branches: the kernel's output shape and dtype, its formula
# reported to the counter, and no launch
# ---------------------------------------------------------------------------

def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


META_CALLS = {
    "similarity": (lambda: cosine_similarity(
        _meta((5, 33), torch.bfloat16), _meta((70, 33), torch.bfloat16)),
        [((5, 70), torch.float32)],
        sim_k.cost(5, 70, 33, torch.bfloat16)),
    "list_merge": (lambda: merge_insert(
        _meta((7, 13)), _meta((7, 13), torch.int32), _meta((7, 3)),
        _meta((3,), torch.int32)),
        [((7, 13), torch.float32), ((7, 13), torch.int32)],
        merge_k.cost(7, 13, 3)),
    "knn_score": (lambda: knn_scores(
        _meta((50, 37)), _meta((3, 5)), _meta((3, 5), torch.int64),
        _meta((3,), torch.int64)),
        [((3, 37), torch.float32)], knn_k.cost(50, 37, 3, 5)),
    "twin_probe": (lambda: twin_probe(_meta((3, 517)), _meta((3,))),
                   [((517,), torch.bool), ((), torch.int32)],
                   probe_k.cost(3, 517)),
    "verify_rows": (lambda: verify_rows(
        _meta((7, 1001), torch.int8), _meta((1001,), torch.int8),
        _meta((7,), torch.bool)), [((7,), torch.bool)],
        verify_k.cost(7, 1001, torch.int8)),
    "embedding_bag": (lambda: embedding_bag(
        _meta((37, 7)), _meta((5, 3), torch.int32),
        mask=_meta((5, 3), torch.bool)), [((5, 7), torch.float32)],
        bag_k.cost(37, 5, 3, 7, weighted=False, masked=True)),
}


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_meta_branch_counts_the_formula(name):
    call, outs, cost = META_CALLS[name]
    before = _lib.KERNELS[name].launches
    with Counter() as counter:
        out = call()
    out = out if isinstance(out, tuple) else (out,)
    assert [(tuple(o.shape), o.dtype) for o in out] == outs
    assert all(o.is_meta for o in out)
    assert counter.kernels[name] == {"calls": 1, "flops": cost.flops,
                                     "bytes": cost.bytes}
    assert _lib.KERNELS[name].launches == before      # nothing launched
    assert _lib.COUNTER is None


@pytest.mark.parametrize("name", sorted(META_CALLS))
def test_meta_branch_reports_nothing_without_a_counter(name):
    assert _lib.COUNTER is None
    META_CALLS[name][0]()


def test_cpu_path_counts_its_plain_operations_not_the_kernel():
    rng = np.random.default_rng(0)
    Q = torch.as_tensor(rng.standard_normal((4, 6)), dtype=torch.float32)
    R = torch.as_tensor(rng.standard_normal((9, 6)), dtype=torch.float32)
    with Counter() as counter:
        cosine_similarity(Q, R)
    assert counter.kernels == {}
    assert counter.flops_f32 == 2 * 4 * 9 * 6    # the plain version's mm


# ---------------------------------------------------------------------------
# HBM bytes of indexed operations: the elements they touch
# ---------------------------------------------------------------------------

TABLE = (4_000_000, 64)            # a 1 GB float32 table, on meta


@pytest.mark.parametrize("gather", ["index", "index_select", "embedding",
                                    "gather"])
def test_gather_counts_the_rows_it_reads(gather):
    """A lookup of 512 x 39 rows from a large table reads those rows and
    its indices and writes its output, whatever op implements it."""
    table = _meta(TABLE)
    idx = _meta((512, 39), torch.int64)
    flat = idx.reshape(-1)
    calls = {
        "index": lambda: table[idx],
        "index_select": lambda: table.index_select(0, flat),
        "embedding": lambda: torch.nn.functional.embedding(idx, table),
        "gather": lambda: torch.gather(
            table, 0, flat[:, None].expand(-1, TABLE[1])),
    }
    with Counter() as counter:
        calls[gather]()
    rows = idx.numel() * TABLE[1] * 4
    idx_b = (idx.numel() * (TABLE[1] if gather == "gather" else 1)) * 8
    assert counter.bytes == 2 * rows + idx_b
    assert counter.bytes < TABLE[0] * TABLE[1] * 4 / 50


def test_gather_reads_at_most_its_source():
    src = _meta((10, 8))
    with Counter() as counter:
        src[_meta((1000,), torch.int64)]
    assert counter.bytes == 1000 * 8 + 10 * 8 * 4 + 1000 * 8 * 4


@pytest.mark.parametrize("inplace", [True, False])
def test_scatter_counts_the_rows_it_touches(inplace):
    """A segment sum of 20,000 rows into a large destination reads its
    indices and source and reads and writes the rows they name; an
    out-of-place one is charged as an in-place update."""
    dest = _meta(TABLE)
    ids = _meta((20_000,), torch.int64)
    src = _meta((20_000, TABLE[1]))
    with Counter() as counter:
        if inplace:
            dest.index_add_(0, ids, src)
        else:
            dest.index_add(0, ids, src)
    rows = src.numel() * 4
    assert counter.bytes == ids.numel() * 8 + rows + 2 * rows


def test_fill_and_copy_write_without_reading():
    dest, src = _meta((1000, 10)), _meta((1000, 10))
    with Counter() as counter:
        dest.zero_()
        dest.copy_(src)
    assert counter.bytes == 4e4 + 2 * 4e4
