#!/usr/bin/env python3
"""Drive the ``repro_torch`` port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, in order; the script exits non-zero as soon as a check fails:

  1. device  — the card's name and power limit.
  2. build   — every CUDA kernel from ``src/repro_torch/csrc`` (one nvcc
               per source, all at once), with the ``-Xptxas -v`` report.
  3. kernels — each kernel against its plain PyTorch version at the main
               path's shapes (plus a ragged small case), timed with CUDA
               events beside its bound and a library yardstick;
               ``similarity`` at nq = 64 and at the burst's nq = 32 (one
               tile variant each), and bit for bit on integer ratings;
               ``key_dedup`` on a 32-user read batch's keys (7 repeats),
               against its plain version and ``dedup_rows``' plan, timed
               beside its bound, the plain version and the host route it
               replaces; the arena health sweep (``live_rows_ok``, one
               ``verify_rows`` launch) over Douban-width and
               MovieLens-width arenas, flags equal to the plain version's
               clean and poisoned, timed beside it and its bound.
  4. server  — ``CFServer`` at Douban-film width (58,541 items at
               douban_film's density, 32,768 users): build, 48 planted
               twins + 16 fresh profiles into the 64-slot write buffer, one
               more onboard that rotates the arena, ``recommend_batch`` and
               ``predict_batch`` for 256 users, and a 32-user traditional
               burst on a clone of the state.  The launch counts are
               zeroed just before and read just after: every kernel of the
               path (similarity, list_merge, knn_score, key_dedup) must
               have run.
  5. kernel API — ``repro_torch.kernels.twin_probe``, ``verify_rows`` and
               ``embedding_bag`` at shapes the system runs: the 8 probe
               rows of the server's final arena in user order (a planted
               twin's and a fresh profile's probe sims), the server's
               458-row candidate block for a planted twin (f32 and int8),
               and xDeepFM's 60.8M x 10 table under ``serve_bulk`` traffic
               (262,144 bags x 8 Zipf ids).  Counts zeroed before, read
               after: each of the three must have run.  Then each output
               against its plain version (exact), a ragged small case, and
               cold-L2 timings beside the bound, the launch floor (a cold
               one-element fill) and a library yardstick; the cold times
               of ``ops.twin_probe`` and of ``ops.embedding_bag`` with the
               mask, each one kernel a call by the profiler's count; and
               embedding_bag's two thread layouts timed in turns.
  6. durability — a durable ``CFServer`` at the same width: WAL (fsync
               on) and checkpoints in a temporary directory on local disk
               (about 16 GB each, two at once at most), incremental rotation
               in 4,096-row slices, twin and fresh onboards, 32 add_ratings
               (base rows and frozen burst rows while the plan is in
               flight), ``step_maintenance``, one mid-run checkpoint, and
               the onboard that completes the swap.  The live state is
               copied to the host and the server dropped (the crash);
               ``CFServer.recover`` must then equal the copy on every leaf.
               Counts zeroed before, read after: list_merge must have run.
               Then the plan's merge at the phase's own shapes (a 4,096-row
               slice and the dirty rows, k = 48) on the card against the
               plain version on the CPU, bit for bit.  Prints
               ``{"durability": {...}}`` from the servers' ``ServerStats``
               (checkpoint save/restore, WAL append and add_rating
               latencies, init_cache, plan steps, swap pause, recovery
               split) and the peak device memory.
  7. replication — a ``CFServer`` at the same width with
               ``ReplicationConfig(n_shards=4, r=2, rebuild_rows=4096)``
               (two host copies of the arena: the phase first checks the
               host's MemAvailable for them and one shard's slice, what a
               later reset holds beside them): 12
               onboards, then every similarity seam forbidden, node 1
               killed (its replicas gone, its primary shard's rows NaN),
               ``recommend_batch`` until the rows are healed and redundancy
               is back to 2.  The healed arena must equal a clone taken
               before the kill on all five leaves, the ladder must have gone
               to ``degraded`` and back, and no seam may have been called.
               Prints ``{"replication": {...}}``: reset, apply_rows per
               onboard, repair, re-replication rate, the host RAM of the
               replicas, the health check before each read batch.
  8. buffered — ``onboard_batch_buffered(maintain=True)`` over a base
               state of the phase-4 ratings (32,768 users): 16 rows copied
               from base users, 8 fresh profiles and 8 repeats of them, 8
               probes each; the merge of every base row runs on list_merge
               (counts zeroed before, read after).  The flags against the
               burst's construction, the 32 lists against the traditional
               burst on the card (1e-6), and a 4,096-row slice of the
               maintained lists against the plain merge on the CPU, bit for
               bit.  Prints ``{"buffered": {...}}``.
  9. CF family — the ``twinsearch-cf`` architecture through
               ``models.cf`` over the phase-4 ratings (32,768 users: the
               full 129,490-user (N, N) arena would need 134 GB):
               ``build_step`` on the bf16 ratings ``input_structs
               ("douban_build")`` asks for (the similarity kernel), a
               4,096-row slice of its lists against a plain computation on
               the CPU (1e-5) and its product timed beside ``torch.matmul``;
               then ``douban_onboard``'s burst of k = 30 (15 base copies, 8
               fresh, 7 repeats; c = 8) through ``onboard_step`` on a
               one-rank NCCL process group (the sharded burst), and with
               ``maintain=True`` (list_merge), counts zeroed before the
               build and read after the bursts.  Held to
               ``onboard_batch_buffered`` on the same inputs (flags exact,
               lists within 2e-5), a 4,096-row slice of the maintained
               lists to the plain merge on the CPU (bit for bit); the
               collective bytes of each user, counted by wrapping
               ``torch.distributed``'s collectives, beside (2c+2)·N·4.
               Then ``onboard_batch_resilient`` (a NaN row healed) and
               ``build_step`` at ``ml_build`` (943 x 1,682, card against
               CPU), and ``serve_cf`` at its defaults.  Prints
               ``{"cf_family": {...}}``.
 10. recsys  — the recsys family and the training substrate at the
               registered configs' full widths: (a) xDeepFM serving at
               serve_p99 (512 rows, 100 timed forwards, held to the plain
               path on the host within 1e-4) and serve_bulk (262,144 rows
               in 8 slices of 32,768: one call would hold the CIN's 82 GB
               intermediate); (b) xDeepFM training at train_batch through
               ``make_train_step(loss, AdamW(lr=1e-3), accum_steps=8)``,
               3 steps on ``CTRStream(seed=0)`` (step 0's batch's loss must
               fall), and a 512-row microbatch's gradient held to the host
               within 1e-4; (c) ``launch.train.main`` in process, AutoInt
               at train_batch for 2 steps from zeros with a checkpoint,
               then ``--resume`` to step 3; (d) two-tower retrieval_cand,
               1 user against 1,000,000 candidates, top 100, ids held to
               the host's plain path except at near-ties; (e) the
               ``embedding_bag`` launches of the xDeepFM half (counts
               zeroed before the phase, read after (b)): at least one per
               forward and per training microbatch.  Then the kernel at
               the path's shapes (512 x 8, 8,192 x 8) timed cold beside its
               bound, and a serve forward under the profiler.  Prints
               ``{"recsys": {...}}``.
 11. LM family — gemma3-1b and OLMoE-1B-7B at the registered configs'
               full widths, seeded random bf16 weights drawn on the card:
               (a) ``LMServer`` serves 16 prompts of 2,048 tokens from
               ``TokenPipeline`` (8 distinct, each twice), 32 new tokens,
               with and without dedup (completions equal, 8 and 16 prefill
               rows, savings 0.5), prefill and decode steps timed by CUDA
               events, one decode step under the profiler; (b) 2 prompts
               cut to 256 tokens and 4 decode steps on the card against the
               host's plain path with the same weights (logits within a
               stated bf16 bound, greedy tokens equal except near-ties);
               (c) the reference's cells through ``steps.build_cell`` on a
               (1, 1) mesh: prefill_32k (batch cut from 32 to 1),
               decode_32k and long_500k at full shape (8 steps each),
               train_4k (batch cut
               from 256 to 8; 2 steps, finite losses, peak within 60 GB);
               (d) OLMoE-1B-7B serving 8 prompts of 1,024 tokens (4
               distinct), 16 new tokens, and its first 2 layers against the
               host.  Counts zeroed before, read after: the LM path
               launches none of the seven kernels.  Prints ``{"lm": {...}}``.
 11b. MoE-EP  — OLMoE-1B-7B on a (1, 1) mesh over a one-rank NCCL group,
               where the reference's rule routes every train and prefill
               MoE layer through ``models.moe_ep``: the hooks' ``moe_ep``
               checked; ``moe_ffn_ep`` against ``moe_ffn`` on one
               full-width layer at 4,096 tokens and capacity factor E/k
               (nothing drops), output, aux loss and the four gradients
               within the bounds PERF.md states, each forward timed; then
               through ``steps.build_cell`` prefill_32k at 16 layers (batch
               cut from 32 to 1) and train_4k (cut to 4 of 16 layers and
               batch 8 of 256; 2 AdamW steps, finite losses, peak within
               70 GB), each timed by CUDA events and once under the
               profiler, every ``moe_ffn_ep`` call counted.  Counts zeroed
               before, read after: the path launches none of the seven
               kernels.  Prints ``{"moe_ep": {...}}``.
 12. GNN family — the four ``gat-cora`` cells through ``steps.build_cell``
               at their registered sizes, seeded random weights, host data
               from ``data/graph.py`` padded as ``input_structs`` states
               (padding edges are self-loops on dead tail nodes, masked
               out): full_graph_sm (``cora_like``) and ogb_products
               (2,449,029 nodes, 61,859,140 edges plus self-loops, padded to
               2,449,408 and 64,308,224; the edge-parallel GAT in message
               chunks) on a one-rank NCCL process group; minibatch_lg (a
               ``NeighborSampler`` block of 1,024 roots, fanout (15, 10),
               over a 232,965-node, 114,615,892-edge graph); molecule (128
               graphs).  Each: one warm-up and 3 timed AdamW steps on one
               batch (finite losses, step 0's loss falls); the first
               step's loss and every gradient leaf on the card against the
               CPU plain path (ogb_products: the chunked edge-parallel loss
               against the unchunked plain loss on the card, on the first
               2**22 edges plus self-loops), within the bounds PERF.md
               states; one step under the profiler (not molecule).  Counts
               zeroed before, read after: the GNN path launches none of the
               seven kernels.  Prints ``{"gnn": {...}}``.
 12b. roofline — (a) ``python -m repro_torch.launch.dryrun --all`` in a
               subprocess that sees no card (``CUDA_VISIBLE_DEVICES=""``):
               88 records, 82 ok and 6 skipped (long_500k of gemma-7b,
               granite-20b and olmoe-1b-7b on both meshes), its seconds and
               one line per cell; (b) ``models.cf.build_step`` at 32,768 x
               58,541 in bf16 and one xDeepFM serve_p99 forward on the card
               under ``launch.trace.Counter``, each against the same call on
               ``meta``: FLOPs, bytes and kernel calls equal, the kernel
               launched once a counted call, the build's similarity call
               2·32,768²·58,541 FLOP; (c) the (1, 1)-mesh roofline
               (``jit_cell(...).lower(...).compile()``) of four cells that
               earlier phases time, at their sizes (the build at 32,768
               users, xDeepFM serve_p99, gemma3-1b prefill_32k at batch 1,
               gat-cora ogb_products), and each measured time / bound.
               Prints ``{"roofline": {...}}``.
 13. movielens — the same request script at 943 x 1,682 on the card and on
               the CPU (the plain versions), held to the parity tests'
               tolerances.
 14. summary — ``{"kernels": [...]}`` (all seven kernels, each with the
               launches of the phases that drove it: 4, 6, 7, 8 and 9 for
               the main path's four, 5 for the others, 10 for
               ``embedding_bag``, and 12b for ``similarity`` and
               ``embedding_bag``; phases 11, 11b and 12 launch none), the
               nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

It imports neither ``jax`` nor the JAX package, and refuses to run (exit 2)
without a CUDA device or without ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
FP32_FLOPS_PER_S = 67e12         # fp32 on the CUDA cores, no tensor cores
BF16_FLOPS_PER_S = 989e12        # bf16 on the tensor cores, dense
DOUBAN_USERS, DOUBAN_ITEMS, DOUBAN_RATINGS = 129_490, 58_541, 16_830_839
N_USERS = 32_768                 # the full (N, N) arena would need 134 GB
CAPACITY_EXTRA = 64
# The ml20m-onboard cell's base: 40,960 users of MovieLens 20M's 27,278
# items.
ML20M_ROWS, ML20M_ITEMS = 40_960, 27_278
C_PROBES = 8
DEVICE = "cuda"
# Kernel checks at the main path's shapes: the rotation's merge over the
# base rows (checked in one launch), the similarity product of 64 and of 32
# (the burst) users against the arena, and a 256-user recommend batch at
# k = 20.
MERGE_SHAPE = (N_USERS, N_USERS + 2 * CAPACITY_EXTRA, CAPACITY_EXTRA)
SIM_NQS = (64, 32)               # the 64-row tile; the server's burst
KNN_B, KNN_K = 256, 20
DEDUP_B, DEDUP_REPEATS = 32, 7   # the read cell's batch, its twin share
BURST = 32
# Phase 6: rotation slices of 4,096 base rows (8 slices for 32,768 rows); a
# checkpoint every 32 onboards (one mid-run, before the plan starts); 32
# add_ratings.
DUR_BUDGET_ROWS, DUR_SNAPSHOT_EVERY, DUR_ADDS = 4096, 32, 32
# Phase 7: 4 shards, 2 copies each, re-replication 4,096 rows a request; 12
# onboards before node 1 dies.
REP_SHARDS, REP_R, REP_REBUILD_ROWS, REP_ONBOARDS = 4, 2, 4096, 12
MAIN_PATH = ("similarity", "list_merge", "knn_score", "key_dedup")
API_KERNELS = ("twin_probe", "verify_rows", "embedding_bag")
# xDeepFM's table and traffic come from ``repro_torch.configs`` (39
# power-law fields, 60,802,963 rows in all, the first 10M; 10 columns;
# RECSYS_SHAPES "serve_bulk", 262,144 rows per batch).  The multi-hot
# field's traffic is ``data/recsys_stream.py``'s rule: 8 Zipf(1.3) ids
# each, valid with probability 0.6.
MULTI_HOT, MULTI_VALID, ZIPF_A = 8, 0.6, 1.3
# The flush before each cold call: far more than the H100's 50 MB L2, and
# long enough on the card (~0.7 ms) that the host has enqueued the call
# before the start event fires, so the events time the card's work.
L2_FLUSH_BYTES = 2 << 30


class CheckFailed(Exception):
    pass


def check(cond: bool, what: str) -> None:
    check_quiet(cond, what)
    print(f"  ok: {what}", flush=True)


def check_quiet(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events, after
    ``warmup`` runs."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps: int, flush) -> float:
    """Mean milliseconds of ``fn`` by CUDA events around each run, with
    ``flush`` (a write larger than L2) before each one, after one warm-up:
    a call that finds its inputs in device memory, not in L2.  The flush
    keeps the stream busy while the host enqueues ``fn``, so a wrapper's
    host work stays outside the events (``call_ms`` measures it)."""
    import torch
    fn()
    total = 0.0
    for _ in range(reps):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def call_ms(fn, reps: int) -> float:
    """Mean host milliseconds per call of ``fn`` over ``reps`` calls back to
    back, ending in a synchronize: for a kernel shorter than its wrapper's
    host work, the wrapper's cost per call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def padded_rows(x):
    """The whole (n, ld) buffer under a ``kernel.row_buffer`` view ``x``:
    its rows with the zero pad columns, at a depth (a multiple of 8 items)
    that cuBLAS's aligned kernels take; the same row products."""
    return x.as_strided((x.shape[0], x.stride(0)), (x.stride(0), 1))


def bound(bytes_moved: float, flops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over their type's peak rate (fp32 on the CUDA cores unless
    ``flops_per_s`` says otherwise), whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else (
        f"nvidia-smi failed: {out.stderr.strip()}")


# ---------------------------------------------------------------------------
# Phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_list_merge(torch, dev) -> dict:
    from repro_torch.kernels.list_merge.kernel import merge_sorted_cuda
    from repro_torch.kernels.list_merge.ops import merge_insert
    from repro_torch.kernels.list_merge.ref import (NEG_INF,
                                                    merge_insert_ref,
                                                    merge_sorted_ref)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def case(R, L, k):
        pool = torch.cat([torch.tensor([-2.0, -2.0], device=dev), torch.round(
            torch.rand(8, device=dev, generator=g) * 200 - 100) / 100])
        vals = torch.empty((R, L), device=dev)
        for r0 in range(0, R, 4096):                  # bounded sort temps
            r1 = min(R, r0 + 4096)
            pick = torch.randint(0, 10, (r1 - r0, L), device=dev,
                                 generator=g)
            vals[r0:r1] = torch.sort(pool[pick], dim=1).values
        idx = torch.randint(0, L, (R, L), device=dev, generator=g,
                            dtype=torch.int32)
        idx[vals == -2.0] = -1                         # rotation padding ids
        ins = torch.round(torch.rand((R, k), device=dev, generator=g)
                          * 290 - 190) / 100
        ins[0, 0] = vals[0, L // 2]                    # tie with a row entry
        if k > 1:
            ins[:, 1] = ins[:, 0]                      # tie between inserts
        ins_idx = (40_000 + torch.arange(k, device=dev, dtype=torch.int32)
                   ).expand(R, k).contiguous()
        mask = torch.rand((R, k), device=dev, generator=g) < 0.8
        return vals, idx, ins, ins_idx, mask

    small = case(7, 13, 3)
    kv, ki = merge_insert(*small)
    ov, oi = merge_insert_ref(*small)
    check(torch.equal(kv, ov) and torch.equal(ki, oi),
          "list_merge ragged (7, 13, k=3) bit-identical to the plain version")

    R, L, k = MERGE_SHAPE
    vals, idx, ins, ins_idx, mask = case(R, L, k)
    sv, order = torch.sort(torch.where(mask, ins, NEG_INF), dim=1,
                           stable=True)
    si = torch.gather(ins_idx, 1, order)
    kv, ki = merge_sorted_cuda(vals, idx, sv, si)
    torch.cuda.synchronize()
    pv, pi = merge_sorted_ref(vals, idx, sv, si)
    same = torch.equal(kv, pv) and torch.equal(ki, pi)
    err = float((kv - pv).abs().max())
    del pv, pi
    check(same, f"list_merge ({R}, {L}, k={k}) bit-identical to the plain "
          "version")
    ms = cuda_ms(lambda: merge_sorted_cuda(vals, idx, sv, si), reps=5)
    plain_ms = cuda_ms(lambda: merge_sorted_ref(vals, idx, sv, si), reps=1)
    mvals = torch.cat([vals, sv], dim=1)
    lib_ms = cuda_ms(lambda: torch.sort(mvals, dim=1, stable=True), reps=1)
    del mvals, kv, ki
    b_ms, b_by = bound(16.0 * R * L + 8.0 * R * k, 0.0)
    log(f"  list_merge ({R}x{L}, k={k}): kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, torch.sort of the concatenation {lib_ms:.3f} ms"
        f", bound {b_ms:.3f} ms ({b_by})")
    return {"name": "list_merge", "route": "cuda",
            "source": "src/repro_torch/csrc/list_merge.cu",
            "replaces": "src/repro/kernels/list_merge/kernel.py:88",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": [R, L, k]}


def check_list_merge_rows(torch, dev) -> dict:
    """The rotation's merge of the base rows (``merge_rows``, one launch a
    4,096-row chunk) at the server's Douban shape: 32,768 base rows of
    32,832 (the 64 write-region ids on each row's SENTINEL head, as
    onboarding leaves them), k = 64, into the new arena's 32,896 columns.
    Held bit for bit to its plain version, then timed beside it and its
    bound; again with a write-region id planted on a real value of every
    row, so that every row takes the partition."""
    from repro_torch.core.knn import SORT_CHUNK_ROWS
    from repro_torch.kernels.list_merge.kernel import rows_cost
    from repro_torch.kernels.list_merge.ops import merge_rows
    from repro_torch.kernels.list_merge.ref import SENTINEL, merge_rows_ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    n_base, k = N_USERS, CAPACITY_EXTRA
    L, W = n_base + k, n_base + 2 * k
    vals = torch.empty((n_base, L), device=dev)
    idx = torch.empty((n_base, L), dtype=torch.int32, device=dev)
    col = torch.arange(L, device=dev)
    for r0 in range(0, n_base, SORT_CHUNK_ROWS):       # bounded sort temps
        r1 = min(n_base, r0 + SORT_CHUNK_ROWS)
        v = torch.sort(torch.round(torch.rand(
            (r1 - r0, L), device=dev, generator=g) * 200 - 100) / 100 + 0.0,
            dim=1).values
        heads = k + torch.randint(0, 64, (r1 - r0, 1), device=dev,
                                  generator=g)
        v[col[None, :] < heads] = SENTINEL
        vals[r0:r1] = v
        idx[r0:r1, :k] = n_base + col[:k].int()
        idx[r0:r1, k:] = torch.argsort(torch.rand(
            (r1 - r0, n_base), device=dev, generator=g), dim=1).int()
        del v
    U = torch.round(torch.rand((k, n_base), device=dev, generator=g) * 300
                    - 200) / 100 + 0.0
    U[U < -1] = SENTINEL
    U[1] = vals[:, L // 2]                             # ties with row entries
    ids = n_base + torch.arange(k, dtype=torch.int32, device=dev)
    out_v = torch.empty((n_base, W), device=dev)
    out_i = torch.empty((n_base, W), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int32, device=dev)
    chunks = [(r0, min(n_base, r0 + SORT_CHUNK_ROWS))
              for r0 in range(0, n_base, SORT_CHUNK_ROWS)]

    def kernel(idx):
        for r0, r1 in chunks:
            merge_rows(vals, idx, U, ids, slice(r0, r1), out_v, out_i,
                       n_base=n_base, reordered=count)

    def plain(idx):
        for r0, r1 in chunks:
            pv, pi, _ = merge_rows_ref(vals[r0:r1], idx[r0:r1],
                                       U[:, r0:r1].T, ids, n_base=n_base,
                                       width=W)
            yield r0, r1, pv, pi

    out = {"name": "list_merge.rows", "shape": [n_base, L, k, W]}
    b_ms, b_by = bound(rows_cost(n_base, L, k, W).bytes, 0.0)
    for label, rows_idx in (("onboarding", idx), ("every row reordered",
                                                  None)):
        if rows_idx is None:                  # a write-region id on a value
            rows_idx = idx.clone()
            mid = L // 2
            rows_idx[:, [0, mid]] = rows_idx[:, [mid, 0]]
        count.zero_()
        kernel(rows_idx)
        torch.cuda.synchronize()
        reordered = int(count)
        same = all(torch.equal(out_v[r0:r1], pv) and
                   torch.equal(out_i[r0:r1], pi)
                   for r0, r1, pv, pi in plain(rows_idx))
        check(same, f"list_merge rows ({label}) bit-identical to the plain "
              "version")
        ms = cuda_ms(lambda: kernel(rows_idx), reps=5)
        plain_ms = cuda_ms(lambda: list(plain(rows_idx)), reps=1)
        log(f"  list_merge rows ({label}; {n_base}x{L} -> {W}, k={k}, "
            f"{len(chunks)} launches, {reordered} rows reordered): kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by})")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "reordered_rows": reordered}
    out.update({"bound_ms": b_ms, "bound_by": b_by})
    return out


def check_arena_health(torch, dev) -> dict:
    """The server's health sweep (``live_rows_ok``: one ``live_rows_f32``
    launch) at Douban width (32,832 rows, lists 32,832 wide, 58,541 items)
    and MovieLens width (41,024; 41,024; 27,278), every row live, filled
    on the card as onboarding leaves an arena (ascending lists with ties
    behind SENTINEL heads, integer ratings, their norms).  Its flags equal
    to the plain version's (the sliced PyTorch route the server took
    before) on the clean arena and with a row poisoned in each way; then
    timed beside the plain version and the bound, and a whole
    ``arena_healthy`` check (the sweep, the all-reduction and the bool the
    server reads) on the host's clock."""
    from repro_torch.core.types import SENTINEL
    from repro_torch.kernels.verify_rows.kernel import live_cost
    from repro_torch.kernels.verify_rows.ops import (HEALTH_CHUNK_ROWS,
                                                     arena_healthy,
                                                     live_rows_ok)
    from repro_torch.kernels.verify_rows.ref import live_rows_ok_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    out = {"name": "verify_rows.live"}
    for label, n, m in (("douban", N_USERS + CAPACITY_EXTRA, DOUBAN_ITEMS),
                        ("movielens", ML20M_ROWS + CAPACITY_EXTRA,
                         ML20M_ITEMS)):
        L = n
        sv = torch.empty((n, L), device=dev)
        rt = torch.empty((n, m), device=dev)
        col = torch.arange(L, device=dev)
        for r0 in range(0, n, HEALTH_CHUNK_ROWS):
            r1 = min(n, r0 + HEALTH_CHUNK_ROWS)
            v = torch.round(torch.cumsum(torch.rand(
                (r1 - r0, L), device=dev, generator=g) * (2.0 / L), dim=1)
                * 1000) / 1000 - 1.0
            heads = CAPACITY_EXTRA + torch.randint(
                0, 64, (r1 - r0, 1), device=dev, generator=g)
            v[col[None, :] < heads] = SENTINEL
            sv[r0:r1] = v
            del v
            rt[r0:r1] = torch.randint(1, 6, (r1 - r0, m), device=dev,
                                      generator=g) * (torch.rand(
                                          (r1 - r0, m), device=dev,
                                          generator=g) < 0.01)
        nm = torch.linalg.vector_norm(rt, dim=1)
        flags = live_rows_ok(sv, rt, nm, n)
        plain = live_rows_ok_ref(sv, rt, nm, n, HEALTH_CHUNK_ROWS)
        check(torch.equal(flags, plain) and bool(flags.all()),
              f"health sweep ({label}: {n} x ({L} + {m})) flags equal to "
              "the plain version's on the clean arena, every row sound")
        bad = {101: ("list NaN", sv, L // 2, float("nan")),
               n // 2: ("rating +inf", rt, m - 1, float("inf")),
               n - 1: ("rating -inf", rt, 0, float("-inf"))}
        kept = {r: a[r, c].clone() for r, (_, a, c, _) in bad.items()}
        for r, (_, a, c, value) in bad.items():
            a[r, c] = value
        drop = min(L - 1, 4 * 32 * 8 * 5 + 7)    # past a few warps' tiles
        kept_pair = sv[7, drop].clone()
        sv[7, drop] = sv[7, drop - 1] - 0.5
        kept_norm = nm[n - 2].clone()
        nm[n - 2] = -1.0
        flags = live_rows_ok(sv, rt, nm, n)
        plain = live_rows_ok_ref(sv, rt, nm, n, HEALTH_CHUNK_ROWS)
        failed = sorted(torch.nonzero(~flags).flatten().tolist())
        check(torch.equal(flags, plain)
              and failed == sorted([*bad, 7, n - 2]),
              f"health sweep ({label}) flags equal to the plain version's "
              f"with rows {failed} poisoned (NaN and inf in both arrays, a "
              "descending pair, a negative norm)")
        for r, (_, a, c, _) in bad.items():
            a[r, c] = kept[r]
        sv[7, drop], nm[n - 2] = kept_pair, kept_norm
        ms = cuda_ms(lambda: live_rows_ok(sv, rt, nm, n), reps=10)
        plain_ms = cuda_ms(lambda: live_rows_ok_ref(
            sv, rt, nm, n, HEALTH_CHUNK_ROWS), reps=3)
        check_ms = call_ms(lambda: bool(arena_healthy(sv, rt, nm, n)),
                           reps=10)
        b_ms, b_by = bound(live_cost(n, L, m).bytes, 0.0)
        log(f"  health sweep ({label}: {n} rows, lists {L}, {m} items): "
            f"kernel {ms:.3f} ms ({100 * b_ms / ms:.1f}% of the bound), "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}); a "
            f"whole arena_healthy check {check_ms:.3f} ms on the host")
        out[label] = {"shape": [n, L, m], "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "bound_share": b_ms / ms, "check_ms": check_ms,
                      "library_ms": None}
        del sv, rt, nm, flags, plain
        torch.cuda.empty_cache()
    return out


def check_similarity(torch, dev, arena, R_host) -> dict:
    """Both f32 tile variants on the Douban-width arena: nq = 64 (the
    64-row tile) and nq = 32 (the 32-row tile, the server's burst width),
    each against its plain version and timed beside ``torch.matmul``
    (kernel, matmul, matmul, kernel); the bf16 route (one entry point, the
    tensor cores) at both nq on an aligned-stride bf16 copy of the arena,
    against its plain version and timed beside ``torch.mm(...,
    out_dtype=torch.float32)`` on the whole zero-padded buffers likewise
    (and once on the odd-depth views the kernel reads, which cuBLAS takes
    more slowly); then the burst's 32 fresh profiles and 64 such rows
    (integer ratings) bit for bit in both dtypes."""
    import numpy as np
    from repro_torch.data.synthetic import plant_twins
    from repro_torch.kernels.similarity.kernel import (entry_point,
                                                       row_buffer,
                                                       similarity_cuda)
    from repro_torch.kernels.similarity.ops import cosine_similarity
    from repro_torch.kernels.similarity.ref import EPS, similarity_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 1)

    Qs = torch.randn((5, 33), device=dev, generator=g)
    Rs = torch.randn((70, 33), device=dev, generator=g)
    err = float((cosine_similarity(Qs, Rs) - similarity_ref(
        Qs, Rs, Qs.norm(dim=1), Rs.norm(dim=1))).abs().max())
    check(err <= 1e-5, f"similarity ragged (5 x 70 x 33) within 1e-5 "
          f"(max err {err:.3g})")

    n, m = arena.shape
    rn = torch.sqrt(torch.sum(torch.square(arena), dim=1)).clamp_min(EPS)
    # The bf16 route reads rows by TMA: a row stride of roundup(m, 8) items.
    Rb = row_buffer(n, m, torch.bfloat16, dev).copy_(arena)
    variants = {}
    for nq in SIM_NQS:
        Q = torch.randn((nq, m), device=dev, generator=g)
        qn = torch.sqrt(torch.sum(torch.square(Q), dim=1)).clamp_min(EPS)
        out = similarity_cuda(Q, arena, qn, rn)
        err = float((out - similarity_ref(Q, arena, qn, rn)).abs().max())
        check(err <= 1e-5, f"similarity f32 ({nq} x {n} x {m}, "
              f"{entry_point(Q.dtype, nq)}) within 1e-5 (max err {err:.3g})")
        Qb = row_buffer(nq, m, torch.bfloat16, dev).copy_(Q)
        err_b = float((similarity_cuda(Qb, Rb, qn, rn)
                       - similarity_ref(Qb, Rb, qn, rn)).abs().max())
        check(err_b <= 1e-5, f"similarity bf16 ({nq} x {n} x {m}, "
              f"{entry_point(Qb.dtype, nq)}) within 1e-5 (max err "
              f"{err_b:.3g})")
        del out
        kernel = lambda: similarity_cuda(Q, arena, qn, rn)   # noqa: E731
        matmul = lambda: torch.matmul(Q, arena.T)            # noqa: E731
        turns = [cuda_ms(kernel, 5), cuda_ms(matmul, 5), cuda_ms(matmul, 5),
                 cuda_ms(kernel, 5)]
        ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        kernel_b = lambda: similarity_cuda(Qb, Rb, qn, rn)   # noqa: E731
        Qp, Rp = padded_rows(Qb), padded_rows(Rb)
        mm_b = lambda: torch.mm(Qp, Rp.T,                    # noqa: E731
                                out_dtype=torch.float32)
        err_lib = float((kernel_b() - mm_b() / (qn[:, None] * rn))
                        .abs().max())
        turns_b = [cuda_ms(kernel_b, 5), cuda_ms(mm_b, 5), cuda_ms(mm_b, 5),
                   cuda_ms(kernel_b, 5)]
        ms_b = (turns_b[0] + turns_b[3]) / 2
        lib_b = (turns_b[1] + turns_b[2]) / 2
        lib_odd = cuda_ms(lambda: torch.mm(Qb, Rb.T,
                                           out_dtype=torch.float32), 5)
        plain_ms = cuda_ms(lambda: similarity_ref(Q, arena, qn, rn), reps=3)
        flops = 2.0 * nq * n * m
        moved = 4.0 * (nq * m + n * m + nq * n + nq + n)
        b_ms, b_by = bound(moved, flops)
        moved_b = 2.0 * (nq * m + n * m) + 4.0 * (nq * n + nq + n)
        bb_ms, bb_by = bound(moved_b, flops, BF16_FLOPS_PER_S)
        log(f"  similarity f32 ({nq}x{n}x{m}, {entry_point(Q.dtype, nq)}): "
            f"kernel {ms:.3f} ms ({turns[0]:.3f}, {turns[3]:.3f}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {moved / ms / 1e6:.0f} GB/s, "
            f"{b_ms / ms:.0%} of the bound), torch.matmul {lib_ms:.3f} ms "
            f"({turns[1]:.3f}, {turns[2]:.3f}), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")
        log(f"  similarity bf16 ({nq}x{n}x{m}, {entry_point(Qb.dtype, nq)}):"
            f" kernel {ms_b:.3f} ms ({turns_b[0]:.3f}, {turns_b[3]:.3f}; "
            f"{moved_b / ms_b / 1e6:.0f} GB/s, {bb_ms / ms_b:.0%} of the "
            f"bound), torch.mm(out_dtype=float32) on the padded buffers "
            f"{lib_b:.3f} ms ({turns_b[1]:.3f}, {turns_b[2]:.3f}; max diff "
            f"to the kernel after the norms {err_lib:.3g}), on the odd-depth "
            f"views {lib_odd:.3f} ms, bound {bb_ms:.3f} ms ({bb_by}, bf16 "
            f"rate)")
        variants[str(nq)] = {
            "entry": entry_point(Q.dtype, nq), "shape": [nq, n, m],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "turns_ms": turns, "bf16": {
                "entry": entry_point(Qb.dtype, nq), "ms": ms_b,
                "max_abs_err": err_b, "bound_ms": bb_ms, "bound_by": bb_by,
                "library_ms": lib_b, "library_odd_depth_ms": lib_odd,
                "library_max_abs_diff": err_lib, "turns_ms": turns_b}}
        del Qb, Qp, Rp

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off for the plain version's fp32 matmul")
    fresh = np.stack([plant_twins(R_host, 1, seed=SEED + 100 + i)[0]
                      for i in range(16, 16 + 64)]).astype(np.float32)
    for k in (BURST, 64):
        Qi = torch.as_tensor(fresh[:k], device=dev)
        qn = torch.sqrt(torch.sum(torch.square(Qi), dim=1)).clamp_min(EPS)
        Qib = row_buffer(k, m, torch.bfloat16, dev).copy_(Qi)
        for Qk, Rk in ((Qi, arena), (Qib, Rb)):
            check(torch.equal(similarity_cuda(Qk, Rk, qn, rn),
                              similarity_ref(Qk, Rk, qn, rn)),
                  f"similarity on {k} fresh integer-rating profiles x {n} x "
                  f"{m} in {Qk.dtype} ({entry_point(Qk.dtype, k)}) "
                  "bit-identical to the plain version")
    del Rb
    e = dict(variants[str(BURST)])
    e.update({"name": "similarity", "route": "cuda",
              "source": "src/repro_torch/csrc/similarity.cu",
              "replaces": "src/repro/kernels/similarity/kernel.py:49",
              "variants": variants})
    return e


def check_knn_score(torch, dev, arena) -> dict:
    from repro_torch.kernels.knn_score.ops import knn_scores
    from repro_torch.kernels.knn_score.kernel import knn_scores_cuda
    from repro_torch.kernels.knn_score.ref import knn_scores_ref
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    N, m = arena.shape

    small = arena[:50, :37].contiguous()
    w = torch.randn((3, 5), device=dev, generator=g).clamp_min(0)
    nb = torch.randint(0, 50, (3, 5), device=dev, generator=g)
    us = torch.randint(0, 50, (3,), device=dev, generator=g)
    check(torch.equal(knn_scores(small, w, nb, us),
                      knn_scores_ref(small, w, nb, us)),
          "knn_score ragged (B=3, k=5, m=37) bit-identical to the plain "
          "version")

    B, k = KNN_B, KNN_K
    w = torch.randn((B, k), device=dev, generator=g).clamp_min(0)
    w[:, -3:] = 0.0                                # dead neighbour slots
    nbrs = torch.randint(0, N, (B, k), device=dev, generator=g,
                         dtype=torch.int32)
    users = torch.randint(0, N, (B,), device=dev, generator=g,
                          dtype=torch.int32)
    out = knn_scores_cuda(arena, w, nbrs, users)
    ref = knn_scores_ref(arena, w, nbrs.long(), users.long())
    same = torch.equal(out, ref)
    check(same, f"knn_score (B={B}, k={k}, N={N}, m={m}) bit-identical to "
          "the plain version")
    ms = cuda_ms(lambda: knn_scores_cuda(arena, w, nbrs, users), reps=5)
    plain_ms = cuda_ms(lambda: knn_scores_ref(arena, w, nbrs.long(),
                                              users.long()), reps=2)
    rows = int(torch.unique(torch.cat([nbrs.flatten(), users])).numel())
    b_ms, b_by = bound(4.0 * rows * m + 8.0 * B * k + 4.0 * B
                       + 4.0 * B * m, 4.0 * B * k * m + B * m)
    log(f"  knn_score (B={B}, k={k}, m={m}, {rows} distinct rows): kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by})")
    return {"name": "knn_score", "route": "cuda",
            "source": "src/repro_torch/csrc/knn_score.cu",
            "replaces": "src/repro/kernels/knn_score/kernel.py:57",
            "max_abs_err": 0.0 if same else float("inf"), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": [B, k, N, m]}


def check_key_dedup(torch, dev, arena) -> dict:
    """The read path's twin dedup at Douban width: a batch of ``DEDUP_B``
    users, ``DEDUP_REPEATS`` of them repeats, keyed on 20 sims (a slice of
    a wider sort, as the top-k leaves them), 20 neighbour ids and each
    user's row read in the arena.  Both launches against the plain
    version and the plan against ``dedup_rows`` over the same keys on the
    host.  Timed cold (an L2 flush before each call, which also keeps the
    stream busy while the host enqueues, so the events time the card's
    work: one call's host time exceeds its device time), the pair and
    each launch alone, beside the bound (with the compares the batch
    needs, one a repeat) and the launch floor; the plain version on the
    card; the host's time a call (launches, the copy of the answer, the
    plan) and the host route the kernel replaces (the keys' copies,
    ``dedup_rows``)."""
    import numpy as np
    from repro_torch.kernels.key_dedup import ops
    from repro_torch.kernels.key_dedup.kernel import cost
    from repro_torch.kernels.key_dedup.ref import (key_words, probe_ref,
                                                   verify_ref)
    from repro_torch.serving.cf_server import plan_of_first
    from repro_torch.serving.dedup import dedup_rows
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    m = arena.shape[1]
    B, k, n = DEDUP_B, KNN_K, DEDUP_B - DEDUP_REPEATS
    which = torch.cat([torch.arange(n, device=dev),
                       torch.arange(DEDUP_REPEATS, device=dev)])
    which = which[torch.randperm(B, device=dev, generator=g)]
    users = torch.randperm(N_USERS, device=dev, generator=g)[:n][which]
    wide = torch.sort(torch.rand((n, 64), device=dev, generator=g),
                      dim=1, descending=True).values[which]
    nbrs = torch.randint(0, N_USERS, (n, k), device=dev, generator=g,
                         dtype=torch.int32)[which]
    key = (wide[:, :k], nbrs, arena, users)

    def host_route():
        keys = np.concatenate([key[0].cpu().numpy().view(np.uint32),
                               nbrs.cpu().numpy().view(np.uint32),
                               arena[users].cpu().numpy().view(np.uint32)],
                              axis=1)
        return dedup_rows(keys)

    hashes = ops.probe(*key)
    first = ops.verify(*key, hashes)
    words = key_words(*key)
    plan, want = plan_of_first(first), host_route()
    same = (torch.equal(hashes, probe_ref(words))
            and torch.equal(first, verify_ref(words, hashes))
            and np.array_equal(plan.unique_rows, want.unique_rows)
            and np.array_equal(plan.scatter, want.scatter))
    check(same and plan.n_unique == n,
          f"key_dedup (B={B}, {k} + {k} + {m} words) hashes and answer "
          f"equal to the plain version's, plan equal to dedup_rows' "
          f"({plan.n_unique} unique)")
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    one = torch.empty(1, device=dev)
    floor_ms = cold_ms(lambda: one.fill_(1.0), 20, scratch.zero_)
    ms = cold_ms(lambda: ops.first_twins(*key), 20, scratch.zero_)
    probe_ms = cold_ms(lambda: ops.probe(*key), 20, scratch.zero_)
    verify_ms = cold_ms(lambda: ops.verify(*key, hashes), 20, scratch.zero_)
    del scratch
    host_ms = call_ms(lambda: plan_of_first(ops.first_twins(*key)),
                      reps=200)
    plain_ms = cuda_ms(lambda: verify_ref(key_words(*key),
                                          probe_ref(key_words(*key))),
                       reps=3)
    t0 = time.perf_counter()
    for _ in range(3):
        host_route()
    route_ms = (time.perf_counter() - t0) * 1e3 / 3
    c = cost(B, 2 * k + m, pairs=B - n)
    b_ms, b_by = bound(c.bytes, c.flops)
    log(f"  key_dedup (B={B}, W={2 * k + m}, {B - n} repeats), cold: "
        f"kernel {ms:.4f} ms (probe {probe_ms:.4f}, verify "
        f"{verify_ms:.4f}), launch floor {floor_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}); host {host_ms:.4f} ms a call; plain "
        f"{plain_ms:.3f} ms; host route {route_ms:.1f} ms")
    return {"name": "key_dedup", "route": "cuda",
            "source": "src/repro_torch/csrc/key_dedup.cu",
            "replaces": "none (serving/dedup.py::dedup_rows on the host)",
            "max_abs_err": 0.0, "ms": ms, "probe_ms": probe_ms,
            "verify_ms": verify_ms, "launch_floor_ms": floor_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "host_call_ms": host_ms,
            "host_route_ms": route_ms,
            "shape": [B, 2 * k + m]}


# ---------------------------------------------------------------------------
# Phase 4: the server at Douban width
# ---------------------------------------------------------------------------

def device_share(torch, fn, reps: int = 3) -> dict:
    """Wall time of ``fn`` and the time of the device work it ran (kernels,
    copies), from ``torch.profiler`` over ``reps`` calls: their ratio is
    the share of the request the card was busy.  Prints the device entries
    that took the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()                                           # first-call effects
    torch.cuda.synchronize()
    # A short trace now and then comes back with no device rows at all
    # (seen once on ops.twin_probe): trace again, up to 3 times, and report
    # how many traces it took.
    for attempts in range(1, 4):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6 / reps
        device = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        rows = sorted(((e.self_device_time_total / reps, e.key)
                       for e in device), reverse=True)
        if rows:
            break
        log(f"    wall {wall_us / 1e3:.3f} ms, device time not measured (the "
            "trace holds no device rows)")
    if not rows:
        return {"wall_ms": wall_us / 1e3, "device_ms": None, "top": [],
                "kernels_per_call": None, "attempts": attempts}
    dev_us = sum(t for t, _ in rows)
    # Device operations (kernels, fills, copies) the trace saw per call.
    per_call = sum(e.count for e in device) / reps
    top = ", ".join(f"{k[:48]} {t:.0f}us" for t, k in rows[:5])
    log(f"    wall {wall_us / 1e3:.3f} ms, device {dev_us / 1e3:.3f} ms "
        f"({dev_us / wall_us:.1%} busy), {per_call:g} device operations a "
        f"call, {attempts} trace(s); top: {top}")
    return {"wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "top": [[k, t / 1e3] for t, k in rows[:8]],
            "kernels_per_call": per_call, "attempts": attempts}


def douban_width_ratings():
    """58,541 items at douban_film's density, 32,768 users."""
    from repro_torch.data.synthetic import synth_ratings
    n_ratings = int(DOUBAN_RATINGS * N_USERS / DOUBAN_USERS)
    return synth_ratings(SEED + 1, N_USERS, DOUBAN_ITEMS,
                         max(n_ratings, N_USERS * 5), min_per_user=5)


def run_server(torch, dev, R_host) -> tuple:
    import numpy as np
    from repro_torch.core import clone_state, onboard_batch_traditional
    from repro_torch.data.synthetic import plant_twins
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.verify_rows.ops import arena_healthy
    from repro_torch.serving import CFServer, LadderConfig, ServerConfig
    from repro_torch.training.elastic import StragglerMonitor

    rng = np.random.default_rng(SEED)
    heavy = np.flatnonzero((R_host != 0).sum(axis=1) >= 50)
    check(heavy.size >= 49, f"{heavy.size} base users with >= 50 ratings")
    sources = rng.choice(heavy, size=49, replace=False)
    twins = [plant_twins(R_host, 1, source_user=int(u))[0].astype(np.float32)
             for u in sources]
    fresh = [plant_twins(R_host, 1, seed=SEED + 100 + i)[0].astype(
        np.float32) for i in range(16 + BURST)]
    pool = twins[:48] + fresh[:16]
    stream = [pool[i] for i in rng.permutation(64)] + [twins[48]]
    users = rng.choice(N_USERS, size=KNN_B, replace=False)
    items = rng.integers(0, DOUBAN_ITEMS, size=KNN_B)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    # A twin copy and a fallback build differ by more than the default
    # monitor's 4x straggler ratio at this width, so the default would read
    # the mix of the two as stragglers and walk the ladder to shed.
    monitor = StragglerMonitor(window=64, straggler_ratio=50.0,
                               hang_timeout_s=30.0, consecutive_to_shrink=3)
    srv = CFServer(R_host, ServerConfig(
        capacity_extra=CAPACITY_EXTRA, c_probes=C_PROBES,
        ladder=LadderConfig(monitor=monitor)), device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"  built {N_USERS} x {DOUBAN_ITEMS} arena (capacity "
        f"{srv.state.capacity}) in {build_s:.2f} s")
    results = [srv.onboard_user(r) for r in stream]
    t0 = time.perf_counter()
    recs = srv.recommend_batch(users.tolist(), n=10, k_neighbors=20)
    rec_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    preds = srv.predict_batch(users.tolist(), items.tolist(), k=20)
    pred_s = time.perf_counter() - t0
    burst = torch.as_tensor(np.stack(fresh[16:]), device=dev)
    st = clone_state(srv.state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = onboard_batch_traditional(st, burst)
    torch.cuda.synchronize()
    burst_s = time.perf_counter() - t0
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    s = srv.stats.summary()

    def p50(xs):
        return sorted(xs)[len(xs) // 2] if xs else None

    twin_ms = [r.latency_ms for r in results if r.twin_found]
    fb_ms = [r.latency_ms for r in results if not r.twin_found]
    healthy = bool(arena_healthy(srv.state.sim_vals, srv.state.ratings,
                                 srv.state.norms, srv.state.n_active))
    log(f"  twin hits {s['twin_hits']}, fallbacks {s['fallbacks']}, "
        f"overflows {s['overflows']}, rotations {s['rotations']} "
        f"({s['rotation_max_ms']:.1f} ms), arena_healthy {healthy}")
    metrics = {
        "build_s": build_s, "onboard_p50_ms": s["onboard_p50_ms"],
        "onboard_p99_ms": s["onboard_p99_ms"],
        "first_onboard_ms": results[0].latency_ms,
        "twin_p50_ms": p50(twin_ms),
        "fallback_p50_ms": p50(fb_ms), "rotation_ms": s["rotation_max_ms"],
        "recommend_batch_ms": rec_s * 1e3, "predict_batch_ms": pred_s * 1e3,
        "query_dedup_savings": s["query_dedup_savings"],
        "burst_ms": burst_s * 1e3, "peak_gb": peak / 1e9,
        "twin_hits": s["twin_hits"], "fallbacks": s["fallbacks"],
        "overflows": s["overflows"], "launches": counts}
    log(f"  onboard p50 {s['onboard_p50_ms']:.3f} ms (twin "
        f"{metrics['twin_p50_ms']}, fallback {metrics['fallback_p50_ms']}),"
        f" p99 {s['onboard_p99_ms']:.3f} ms (first request "
        f"{results[0].latency_ms:.1f} ms); recommend_batch({KNN_B}) "
        f"{rec_s * 1e3:.1f} ms; predict_batch {pred_s * 1e3:.1f} ms; "
        f"traditional burst of {BURST} {burst_s * 1e3:.1f} ms; peak memory "
        f"{peak / 1e9:.2f} GB; launches {counts}")
    check(all(r.status == "ok" for r in results), "every onboard ok")
    check(s["rotations"] == 1 and results[-1].rotated,
          "the 65th onboard rotated the arena once")
    check(s["twin_hits"] > 0, f"twin hits > 0 ({s['twin_hits']})")
    check(healthy, "arena_healthy after rotation")
    check(all(len(r) == 10 and all(np.isfinite(v) for _, v in r)
              and all(R_host[u, i] == 0 for i, _ in r)
              for u, r in zip(users, recs)),
          f"{len(recs)} recommendations: 10 finite unseen items each")
    # A weighted mean of 1-5 star ratings, up to fp32 rounding.
    check(all(0.0 <= p <= 5.0 + 1e-5 for p in preds),
          f"{len(preds)} predictions in [0, 5]")
    check(st.n_active == srv.state.n_active + BURST,
          f"{BURST}-user traditional burst appended")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32,
          "TF32 is off for fp32 matmuls and convolutions")
    for name in MAIN_PATH:
        check(counts[name] > 0, f"kernel {name} launched {counts[name]} "
              "times on the main path")
    check(counts["verify_rows"] > 0, f"the server's health checks launched "
          f"the verify_rows sweep {counts['verify_rows']} times")

    # After the main path was read: profile a few more requests (they land
    # in free write slots and change none of the numbers above).
    profiles = {
        "twin onboard": lambda: srv.onboard_user(twins[int(rng.integers(48))]),
        "fallback onboard": lambda: srv.onboard_user(
            plant_twins(R_host, 1, seed=int(rng.integers(1 << 30)))[0]),
        f"recommend_batch({KNN_B})": lambda: srv.recommend_batch(
            users.tolist(), n=10, k_neighbors=20)}
    metrics["device_busy"] = {}
    for name, fn in profiles.items():
        log(f"  {name}:")
        metrics["device_busy"][name] = device_share(torch, fn)
    return metrics, srv


# ---------------------------------------------------------------------------
# Phase 5: the kernel API (twin_probe, verify_rows, embedding_bag)
# ---------------------------------------------------------------------------

def cf_api_inputs(torch, srv, R_host) -> dict:
    """From the server's final arena: the c probe rows scattered back to
    user order (free slots SENTINEL), a planted twin's and a fresh
    profile's probe sims, and the candidate block that ``verify_candidates``
    gathers for the twin (s_max lowest-indexed candidates + the k_cap
    onboarding rows)."""
    import numpy as np
    from repro_torch.core import twinsearch as ts
    from repro_torch.core.types import SENTINEL, active_mask
    from repro_torch.data.synthetic import plant_twins
    from repro_torch.sorting import top_k
    st, dev = srv.state, srv.device
    N = st.capacity
    rng = np.random.default_rng(SEED + 7)
    probes = torch.as_tensor(rng.choice(srv.n_base, C_PROBES, replace=False),
                             device=dev)
    ids = st.sim_idx[probes].long()
    live = ids >= 0
    rows = torch.full((C_PROBES, N), SENTINEL, device=dev)
    owner = torch.arange(C_PROBES, device=dev)[:, None].expand_as(ids)
    rows[owner[live], ids[live]] = st.sim_vals[probes][live]

    heavy = np.flatnonzero((R_host != 0).sum(axis=1) >= 50)
    source = int(rng.choice(heavy))
    twin = torch.as_tensor(R_host[source].astype(np.float32), device=dev)
    fresh = torch.as_tensor(plant_twins(R_host, 1, seed=SEED + 300)[0]
                            .astype(np.float32), device=dev)
    s0_twin = ts.probe_sims(st, twin, probes)
    s0_fresh = ts.probe_sims(st, fresh, probes)

    cand = ts.candidate_mask(st, probes, s0_twin, srv.tol) & active_mask(st)
    _, cidx = top_k(cand.float(), srv.s_max)
    valid = cand[cidx]
    blk = srv.n_base + torch.arange(srv.k_cap, device=dev)
    cidx = torch.cat([cidx, torch.clamp(blk, max=N - 1)])
    valid = torch.cat([valid, blk < st.n_active])
    C = st.ratings[cidx].contiguous()
    return {"rows": rows, "s0_twin": s0_twin,
            "s0_fresh": s0_fresh, "tol": srv.tol, "source": source,
            "C": C, "r0": twin, "valid": valid, "cidx": cidx,
            "candidate_masks": [
                ts.candidate_mask(st, probes, s0, srv.tol)
                for s0 in (s0_twin, s0_fresh)]}


def bag_api_inputs(torch, dev) -> dict:
    """xDeepFM's table drawn on the card from a seeded generator, and one
    serve_bulk batch of its multi-hot field: Zipf(1.3) ids into field 0's
    rows by ``data/recsys_stream.py``'s rule, a 0.6 validity mask and
    random weights, all made with numpy from the seed."""
    import numpy as np
    from repro_torch.configs import get_arch
    spec = get_arch("xdeepfm")
    rows, dim = spec.config.total_vocab, spec.config.embed_dim
    field0 = spec.config.field_vocab_sizes[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    table = torch.randn((rows, dim), device=dev, generator=g)
    rng = np.random.default_rng(SEED + 3)
    shape = (spec.shape("serve_bulk").dim("batch"), MULTI_HOT)
    idx = ((rng.zipf(ZIPF_A, size=shape) - 1) % field0).astype(np.int32)
    mask = rng.random(shape) < MULTI_VALID
    w = rng.random(shape).astype(np.float32)
    return {"table": table, "idx": torch.as_tensor(idx, device=dev),
            "w": torch.as_tensor(w, device=dev),
            "mask": torch.as_tensor(mask, device=dev)}


def drive_kernel_api(torch, cf: dict, bags: dict) -> tuple[dict, dict]:
    """The three kernels through ``repro_torch.kernels`` as a caller uses
    them, with the launch counts zeroed just before and read just after."""
    from repro_torch.kernels import (embedding_bag, launch_counts,
                                     reset_launch_counts, twin_probe,
                                     verify_rows)
    torch.cuda.synchronize()
    reset_launch_counts()
    out = {
        "probe_twin": twin_probe(cf["rows"], cf["s0_twin"], tol=cf["tol"]),
        "probe_fresh": twin_probe(cf["rows"], cf["s0_fresh"],
                                  tol=cf["tol"]),
        "flags": verify_rows(cf["C"], cf["r0"], cf["valid"]),
        "flags_i8": verify_rows(cf["C"].to(torch.int8),
                                cf["r0"].to(torch.int8), cf["valid"]),
        "bags": embedding_bag(bags["table"], bags["idx"], bags["w"],
                              bags["mask"])}
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"  kernel API launches: { {k: counts[k] for k in API_KERNELS} }")
    for name in API_KERNELS:
        check(counts[name] > 0, f"kernel {name} launched {counts[name]} "
              "times through the kernel API")
    return out, counts


def check_twin_probe(torch, cf: dict, out: dict, flush,
                     floor_ms: float) -> dict:
    from repro_torch.kernels._lib import TWIN_PROBE
    from repro_torch.kernels.twin_probe.kernel import twin_probe_cuda
    from repro_torch.kernels.twin_probe.ops import twin_probe
    from repro_torch.kernels.twin_probe.ref import twin_probe_ref
    rows, tol = cf["rows"], cf["tol"]
    c, N = rows.shape
    for case, cmask in zip(("twin", "fresh"), cf["candidate_masks"]):
        mask, count = out[f"probe_{case}"]
        pmask, pcount = twin_probe_ref(rows, cf[f"s0_{case}"], tol)
        check(torch.equal(mask, pmask) and int(count) == int(pcount),
              f"twin_probe ({c} x {N}, {case} s0) mask and count "
              f"({int(count)}) equal to the plain version")
        log(f"    against candidate_mask (searchsorted on the sorted lists):"
            f" {int(cmask.sum())} candidates there, "
            f"{int((mask != cmask).sum())} columns differ")
    check(int(out["probe_twin"][1]) > 0,
          f"twin_probe finds the planted twin's source user "
          f"{cf['source']} (mask {bool(out['probe_twin'][0][cf['source']])})")
    g = torch.Generator(device=rows.device).manual_seed(SEED + 4)
    small = torch.round(torch.rand((3, 517), device=rows.device,
                                   generator=g) * 20) / 10 - 1
    small[1, 9] = float("nan")
    ks, kc = twin_probe(small, small[:, 9].clone(), tol=0.05)
    ps, pc = twin_probe_ref(small, small[:, 9].clone(), 0.05)
    check(torch.equal(ks, ps) and int(kc) == int(pc),
          f"twin_probe ragged (3 x 517, NaN, tol 0.05) equal to the plain "
          f"version (count {int(kc)})")

    s0 = cf["s0_twin"]
    ms = cold_ms(lambda: twin_probe_cuda(rows, s0, tol), 20, flush)
    ops_ms = cold_ms(lambda: twin_probe(rows, s0, tol=tol), 20, flush)
    plain_ms = cold_ms(lambda: twin_probe_ref(rows, s0, tol), 20, flush)
    # Back to back, with the cached ctypes prototype and with the cache
    # cleared before every call (the prototype set on every call), in eight
    # alternating turns of 500 calls; the median turn of each.
    cached = lambda: twin_probe_cuda(rows, s0, tol)            # noqa: E731

    def uncached():
        TWIN_PROBE._prototypes.clear()
        twin_probe_cuda(rows, s0, tol)
    turns = {"cached": [], "uncached": []}
    for order in ((cached, uncached), (uncached, cached)) * 4:
        for fn in order:
            turns["cached" if fn is cached else "uncached"].append(
                call_ms(fn, 500))
    host_ms = statistics.median(turns["cached"])
    host_uncached_ms = statistics.median(turns["uncached"])
    b_ms, b_by = bound(4.0 * c * N + 4.0 * c + N + 4, 3.0 * c * N)
    log(f"  twin_probe ({c}x{N}): kernel {ms:.4f} ms, ops.twin_probe "
        f"{ops_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"({b_by}), launch floor {floor_ms:.4f} ms; no single library call; "
        f"{host_ms:.4f} ms per call back to back (median of "
        f"{[round(x, 4) for x in turns['cached']]}), {host_uncached_ms:.4f} "
        f"ms with the prototype set on every call (median of "
        f"{[round(x, 4) for x in turns['uncached']]})")
    log("  ops.twin_probe under the profiler (warm L2):")
    prof = device_share(torch, lambda: twin_probe(rows, s0, tol=tol), 5)
    check(prof["kernels_per_call"] == 1, "ops.twin_probe is one kernel a "
          "call")
    return {"name": "twin_probe", "route": "cuda",
            "source": "src/repro_torch/csrc/twin_probe.cu",
            "replaces": "src/repro/kernels/twin_probe/kernel.py:35",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "launch_floor_ms": floor_ms, "ops_ms": ops_ms,
            "kernels_per_call": prof["kernels_per_call"],
            "call_ms": host_ms, "call_ms_prototype_every_call":
            host_uncached_ms, "profiled": prof, "shape": [c, N],
            "count_twin": int(out["probe_twin"][1]),
            "count_fresh": int(out["probe_fresh"][1])}


def check_verify_rows(torch, cf: dict, out: dict, flush,
                      floor_ms: float) -> dict:
    from repro_torch.kernels.verify_rows.kernel import verify_rows_cuda
    from repro_torch.kernels.verify_rows.ops import verify_rows
    from repro_torch.kernels.verify_rows.ref import verify_rows_ref
    C, r0, valid = cf["C"], cf["r0"], cf["valid"]
    C8, r08 = C.to(torch.int8), r0.to(torch.int8)
    s, m = C.shape
    plain = verify_rows_ref(C, r0, valid)
    check(torch.equal(out["flags"], plain),
          f"verify_rows f32 ({s} x {m}) flags equal to the plain version")
    check(torch.equal(out["flags_i8"], verify_rows_ref(C8, r08, valid))
          and torch.equal(out["flags_i8"], plain),
          f"verify_rows int8 ({s} x {m}) flags equal to the plain version "
          "and to f32")
    hits = out["flags"].nonzero().flatten()
    check(hits.numel() > 0 and bool(torch.all(
        C[hits] == r0[None, :])), f"verify_rows verifies the planted twin "
          f"({hits.numel()} rows: users {cf['cidx'][hits].tolist()})")
    r0s = r0[:1001].clone()
    r0s[0] = 0.0
    small = r0s.repeat(7, 1)
    small[1, 0] = -0.0                             # equal as a value
    small[3, 1000] = float("nan")                  # NaN equals nothing
    small[4, 500] += 1.0
    small[5] = C[0, :1001]
    sv = torch.ones(7, dtype=torch.bool, device=C.device)
    sv[6] = False
    flags = verify_rows(small, r0s, sv)
    check(torch.equal(flags, verify_rows_ref(small, r0s, sv))
          and flags[:5].tolist() == [True, True, True, False, False]
          and not bool(flags[6]),
          "verify_rows ragged (7 x 1001, -0.0, NaN, an invalid twin) equal "
          "to the plain version")

    ms = cold_ms(lambda: verify_rows_cuda(C, r0, valid), 20, flush)
    ms8 = cold_ms(lambda: verify_rows_cuda(C8, r08, valid), 20, flush)
    plain_ms = cold_ms(lambda: verify_rows_ref(C, r0, valid), 20, flush)
    plain_ms8 = cold_ms(lambda: verify_rows_ref(C8, r08, valid), 20, flush)
    host_ms = call_ms(lambda: verify_rows_cuda(C, r0, valid), 200)
    b_ms, b_by = bound(4.0 * (s * m + m) + 2.0 * s, float(s * m))
    b8_ms, _ = bound(1.0 * (s * m + m) + 2.0 * s, float(s * m))
    log(f"  verify_rows ({s}x{m}): f32 kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), launch floor "
        f"{floor_ms:.4f} ms; int8 kernel "
        f"{ms8:.4f} ms, plain {plain_ms8:.4f} ms, bound {b8_ms:.4f} ms; no "
        f"single library call; f32 {host_ms:.4f} ms per call back to back")
    log("  verify_rows f32 under the profiler (warm L2):")
    prof = device_share(torch, lambda: verify_rows_cuda(C, r0, valid), 5)
    return {"name": "verify_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/verify_rows.cu",
            "replaces": "src/repro/kernels/verify_rows/kernel.py:38",
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "int8_ms": ms8, "int8_plain_ms": plain_ms8,
            "int8_bound_ms": b8_ms, "call_ms": host_ms, "profiled": prof,
            "launch_floor_ms": floor_ms,
            "shape": [s, m]}


def check_embedding_bag(torch, bags: dict, out: dict, flush,
                        floor_ms: float) -> dict:
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag.kernel import (
        COLUMN, LAYOUT, PAIR, embedding_bag_cuda)
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    table = bags["table"]
    V, dim = table.shape
    idx = bags["idx"]
    w = bags["w"] * bags["mask"].float()
    B, hot = idx.shape
    plain = embedding_bag_ref(table, idx.long(), w)
    same = torch.equal(out["bags"], plain)
    err = float((out["bags"] - plain).abs().max())
    check(same, f"embedding_bag ({B} bags x {hot}, {V} x {dim} table) "
          "bit-identical to the plain version")
    g = torch.Generator(device=table.device).manual_seed(SEED + 5)
    st = torch.randn((37, 7), device=table.device, generator=g)
    si = torch.randint(-4, 42, (5, 3), device=table.device, generator=g,
                       dtype=torch.int32)
    sw = torch.rand((5, 3), device=table.device, generator=g)
    sm = torch.rand((5, 3), device=table.device, generator=g) < 0.6
    check(torch.equal(embedding_bag(st, si, sw, sm), embedding_bag_ref(
        st, torch.clamp(si.long(), 0, 36), sw * sm.float())),
          "embedding_bag ragged (5 x 3, ids out of range both ways) "
          "bit-identical to the plain version")

    bw, bm = bags["w"], bags["mask"]
    other = COLUMN if LAYOUT == PAIR else PAIR
    check(torch.equal(embedding_bag_cuda(table, idx, bw, bm, layout=other),
                      plain), f"embedding_bag in the {other} layout "
          "bit-identical to the plain version")
    # The kernel on the premultiplied weights (the earlier kernel's work
    # and bound), in the chosen layout and the other one, in turns; then
    # with the mask folded in, and through ops.embedding_bag as a caller
    # calls it.
    turns = {LAYOUT: [], other: []}
    for lay in (LAYOUT, other, other, LAYOUT):
        turns[lay].append(cold_ms(lambda: embedding_bag_cuda(
            table, idx, w, layout=lay), 10, flush))
    ms = statistics.mean(turns[LAYOUT])
    other_ms = statistics.mean(turns[other])
    masked_ms = cold_ms(lambda: embedding_bag_cuda(table, idx, bw, bm), 20,
                        flush)
    ops_ms = cold_ms(lambda: embedding_bag(table, idx, bw, bm), 20, flush)
    plain_ms = cold_ms(lambda: embedding_bag_ref(table, idx.long(), w), 20,
                       flush)
    lib = F.embedding_bag(idx, table, mode="sum", per_sample_weights=w)
    lib_err = float((lib - plain).abs().max())
    lib_ms = cold_ms(lambda: F.embedding_bag(
        idx, table, mode="sum", per_sample_weights=w), 20, flush)
    host_ms = call_ms(lambda: embedding_bag_cuda(table, idx, w), 200)
    rows = int(torch.unique(idx).numel())
    b_ms, b_by = bound(4.0 * rows * dim + 8.0 * B * hot + 4.0 * B * dim,
                       2.0 * B * hot * dim)
    mb_ms, _ = bound(4.0 * rows * dim + 9.0 * B * hot + 4.0 * B * dim,
                     3.0 * B * hot * dim)
    log(f"  embedding_bag ({B} bags x {hot}, {rows} distinct rows of "
        f"{V} x {dim}): kernel {ms:.4f} ms in the {LAYOUT} layout (the "
        f"{other} layout {other_ms:.4f} ms; turns {turns}), with the mask "
        f"folded in {masked_ms:.4f} ms (bound {mb_ms:.4f} ms), "
        f"ops.embedding_bag with the "
        f"mask {ops_ms:.4f} ms, plain {plain_ms:.4f} ms, F.embedding_bag "
        f"{lib_ms:.4f} ms (max diff {lib_err:.3g}), bound {b_ms:.4f} ms "
        f"({b_by}), launch floor {floor_ms:.4f} ms; {host_ms:.4f} ms per "
        "call back to back")
    log("  ops.embedding_bag with the mask under the profiler (warm L2):")
    prof = device_share(torch, lambda: embedding_bag(table, idx, bw, bm), 5)
    check(prof["kernels_per_call"] == 1, "ops.embedding_bag (float32 "
          "weights, bool mask) is one kernel a call")
    log("  F.embedding_bag (the yardstick) under the profiler (warm L2):")
    lib_prof = device_share(torch, lambda: F.embedding_bag(
        idx, table, mode="sum", per_sample_weights=w), 5)
    return {"name": "embedding_bag", "route": "cuda",
            "source": "src/repro_torch/csrc/embedding_bag.cu",
            "replaces": "src/repro/kernels/embedding_bag/kernel.py:36",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_max_abs_err": lib_err, "distinct_rows": rows,
            "launch_floor_ms": floor_ms, "ops_ms": ops_ms,
            "kernels_per_call": prof["kernels_per_call"],
            "layout": LAYOUT, "other_layout": other,
            "other_layout_ms": other_ms, "masked_ms": masked_ms,
            "masked_bound_ms": mb_ms, "call_ms": host_ms, "profiled": prof,
            "library_profiled": lib_prof,
            "shape": [B, hot, V, dim]}


def run_kernel_api(torch, dev, srv, R_host) -> tuple[dict, dict]:
    cf = cf_api_inputs(torch, srv, R_host)
    log(f"  probe rows {tuple(cf['rows'].shape)}, candidate block "
        f"{tuple(cf['C'].shape)} ({int(cf['valid'].sum())} valid)")
    bags = bag_api_inputs(torch, dev)
    out, counts = drive_kernel_api(torch, cf, bags)
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    flush = scratch.zero_
    # The launch floor: the cold time of the least kernel, a one-element
    # fill, beside which the shortest kernels' times are read.
    one = torch.empty(1, device=dev)
    floor_ms = cold_ms(lambda: one.fill_(1.0), 20, flush)
    log(f"  launch floor (one-element fill_, cold): {floor_ms:.4f} ms")
    entries = {
        "twin_probe": check_twin_probe(torch, cf, out, flush, floor_ms),
        "verify_rows": check_verify_rows(torch, cf, out, flush, floor_ms),
        "embedding_bag": check_embedding_bag(torch, bags, out, flush,
                                             floor_ms)}
    return entries, counts


# ---------------------------------------------------------------------------
# Phase 6: durability at Douban width
# ---------------------------------------------------------------------------

def dir_bytes(path: str) -> int:
    """Bytes of the files under ``path``."""
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def pct(xs, q: float):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else None


def durability_stream(R_host) -> tuple[list, list]:
    """Planted twins of heavy users and fresh profiles, interleaved (both
    onboard paths), from the seed; and 32 (item, value) pairs for
    add_rating."""
    import numpy as np
    from repro_torch.data.synthetic import plant_twins
    rng = np.random.default_rng(SEED + 11)
    heavy = np.flatnonzero((R_host != 0).sum(axis=1) >= 50)
    twins = [R_host[int(u)].astype(np.float32)
             for u in rng.choice(heavy, size=44, replace=False)]
    fresh = [plant_twins(R_host, 1, seed=SEED + 500 + i)[0].astype(
        np.float32) for i in range(28)]
    stream = [x for pair in zip(twins, fresh) for x in pair] + twins[28:]
    items = rng.integers(0, DOUBAN_ITEMS, size=DUR_ADDS)
    values = rng.integers(0, 6, size=DUR_ADDS).astype(float)   # 0 removes
    return stream, list(zip(items.tolist(), values.tolist()))


def roomy_tmpdir(prefix: str) -> str:
    """A new temporary directory where there is more room: the system's
    temporary directory or the checkout's build directory."""
    import shutil
    import tempfile
    places = [Path(tempfile.gettempdir()), ROOT / "build"]
    for place in places:
        place.mkdir(parents=True, exist_ok=True)
        u = shutil.disk_usage(place)
        log(f"  {place}: {u.free / 1e9:.1f} GB free of {u.total / 1e9:.1f} "
            "GB")
    place = max(places, key=lambda p: shutil.disk_usage(p).free)
    return tempfile.mkdtemp(prefix=prefix, dir=place)


def run_durability(torch, dev, R_host, sync_rotation_ms: float) -> dict:
    """A durable server at Douban width: WAL (fsync on) and checkpoints on
    local disk, incremental rotation in 4,096-row slices, add_ratings on
    base rows and on frozen burst rows while the plan is in flight, the
    swap; then the live state copied to the host, the server dropped (the
    crash), and ``CFServer.recover`` held to the copy leaf by leaf.  The
    times are the servers' own ``ServerStats``; the plan's merge is held
    to the plain path on its own inputs afterwards."""
    import shutil
    import zlib
    import numpy as np
    from repro_torch.bridge import FIELDS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (CFServer, LadderConfig, RotationConfig,
                                     ServerConfig, SnapshotConfig, WalConfig)
    from repro_torch.training.elastic import StragglerMonitor

    capacity = N_USERS + CAPACITY_EXTRA
    arena_bytes = capacity * (DOUBAN_ITEMS + 1 + 2 * capacity) * 4
    root = roomy_tmpdir("chip_smoke_durability_")
    try:
        check(shutil.disk_usage(root).free > 2.2 * arena_bytes,
              f"room in {root} for two {arena_bytes / 1e9:.2f} GB "
              "checkpoints at once")
        cfg = ServerConfig(
            capacity_extra=CAPACITY_EXTRA, c_probes=C_PROBES,
            snapshot=SnapshotConfig(every=DUR_SNAPSHOT_EVERY, keep=1,
                                    dir=f"{root}/snap"),
            wal=WalConfig(dir=f"{root}/wal", fsync=True),
            rotation=RotationConfig(budget_rows=DUR_BUDGET_ROWS),
            ladder=LadderConfig(monitor=StragglerMonitor(
                window=64, straggler_ratio=50.0, hang_timeout_s=30.0,
                consecutive_to_shrink=3)))
        stream, adds = durability_stream(R_host)
        live, stats, add_ms, counts0, memory, merge_inputs = drive_durable(
            torch, dev, R_host, cfg, stream, adds,
            np.random.default_rng(SEED + 12), launch_counts,
            reset_launch_counts)
        ckpt_bytes = dir_bytes(f"{root}/snap")      # the mid-run checkpoint
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = CFServer.recover(R_host, cfg, device=dev)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        rec_ckpt_bytes = dir_bytes(f"{root}/snap")  # recovery's own
    finally:
        shutil.rmtree(root, ignore_errors=True)

    st = rec.state
    check(st.n_active == int(live["n_active"])
          and rec.n_base == live["n_base"] and st.capacity == live["capacity"],
          f"recovered n_active {st.n_active}, n_base {rec.n_base}, capacity "
          f"{st.capacity} equal the live server's")
    for key in FIELDS[:4]:
        leaf = getattr(st, key)
        same = all(np.array_equal(leaf[r0:r0 + 4096].cpu().numpy(),
                                  live[key][r0:r0 + 4096])
                   for r0 in range(0, leaf.shape[0], 4096))
        check(leaf.shape == live[key].shape and same,
              f"recovered {key} {tuple(leaf.shape)} equal to the live copy")
    check(rec._gen.get_state().equal(live["generator"]),
          "recovered probe generator equal to the live one")
    check(counts["list_merge"] > 0, f"kernel list_merge launched "
          f"{counts['list_merge']} times in the durability phase")
    log(f"  launches in this phase: {counts} (similarity: the server's "
        "single-user traditional build is a mat-vec, cosine_vs_all, in "
        "both packages)")
    rstats = rec.stats
    rec_summary = rstats.summary()
    rec_inits = list(rstats.cache_init_ms)
    rec_save_ms = rstats.snapshot_save_ms[-1]
    del rec, st
    torch.cuda.empty_cache()
    merge_checks = check_plan_merge(torch, dev, merge_inputs)

    # CRC32 and the copy to the host, each on its own, over the live copy's
    # four arrays: the two parts of a save that are not the disk.
    live_bytes = sum(live[key].nbytes for key in FIELDS[:4])
    t0 = time.perf_counter()
    for key in FIELDS[:4]:
        zlib.crc32(memoryview(live[key].reshape(-1)).cast("B"))
    crc_s = time.perf_counter() - t0

    save_s = [ms / 1e3 for ms in stats["snapshot_save_ms"]] + [
        rec_save_ms / 1e3]
    save_bytes = [ckpt_bytes] * len(stats["snapshot_save_ms"]) + [
        rec_ckpt_bytes]
    restore_s = rec_summary["recover_restore_ms"] / 1e3
    replay_s = rec_summary["recover_replay_ms"] / 1e3
    s = stats["summary"]
    plain_adds = [ms for ms, init in add_ms if not init]
    metrics = {
        "users": N_USERS, "items": DOUBAN_ITEMS,
        "dir": str(Path(root).parent),
        "checkpoint_gb": [b / 1e9 for b in save_bytes],
        "checkpoint_save_s": save_s,
        "checkpoint_save_gb_s": [b / 1e9 / t for b, t in zip(save_bytes,
                                                             save_s)],
        "to_host_gb_s": live_bytes / 1e9 / live["to_host_s"],
        "crc32_gb_s": live_bytes / 1e9 / crc_s,
        "checkpoint_restore_s": restore_s,
        "checkpoint_restore_gb_s": ckpt_bytes / 1e9 / restore_s,
        "wal_appends": s["wal_appends"],
        "wal_append_p50_ms": s["wal_append_p50_ms"],
        "wal_append_p99_ms": s["wal_append_p99_ms"],
        "wal_append_max_ms": max(stats["wal_append_ms"]),
        "add_ratings": len(add_ms), "add_rating_p50_ms": pct(plain_adds, 0.5),
        "add_rating_p99_ms": pct(plain_adds, 0.99),
        "add_rating_with_init_ms": [ms for ms, init in add_ms if init],
        "init_cache_s": [ms / 1e3 for ms in stats["cache_init_ms"]],
        "recover_init_cache_s": [ms / 1e3 for ms in rec_inits],
        "plan_steps": len(stats["plan_step_ms"]),
        "plan_step_p50_ms": s["plan_step_p50_ms"],
        "plan_step_max_ms": s["plan_step_max_ms"],
        "plan_restarts": s["plan_restarts"],
        "forced_drains": s["forced_drains"],
        "swap_pause_ms": s["rotation_pause_max_ms"],
        "sync_rotation_pause_ms": sync_rotation_ms,
        "rotation_total_ms": s["rotation_max_ms"],
        "onboarded": s["onboarded"], "twin_hits": s["twin_hits"],
        "fallbacks": s["fallbacks"],
        "recover_s": recover_s, "recover_restore_s": restore_s,
        "recover_replay_s": replay_s, "recover_snapshot_s": save_s[-1],
        "wal_replayed": rec_summary["wal_replayed"],
        "peak_gb": peak / 1e9, "memory_gb": memory, "launches": counts,
        "launches_before_recovery": counts0, "plan_merge": merge_checks}
    log(f"  checkpoints of {', '.join(f'{b / 1e9:.2f}' for b in save_bytes)}"
        f" GB: save {', '.join(f'{t:.2f}' for t in save_s)} s, restore "
        f"{restore_s:.2f} s ({metrics['checkpoint_restore_gb_s']:.2f} GB/s);"
        f" on the live copy ({live_bytes / 1e9:.2f} GB) the copy to the host"
        f" runs at {metrics['to_host_gb_s']:.2f} GB/s and CRC32 at "
        f"{metrics['crc32_gb_s']:.2f} GB/s")
    log(f"  WAL append p50 {metrics['wal_append_p50_ms']:.3f} ms p99 "
        f"{metrics['wal_append_p99_ms']:.3f} ms max "
        f"{metrics['wal_append_max_ms']:.3f} ms ({s['wal_appends']} appends,"
        f" fsync); add_rating p50 {metrics['add_rating_p50_ms']:.3f} ms p99 "
        f"{metrics['add_rating_p99_ms']:.3f} ms ({len(plain_adds)} calls; "
        f"the calls that built the cache: "
        f"{metrics['add_rating_with_init_ms']} ms); init_cache "
        f"{metrics['init_cache_s']} s")
    log(f"  plan step p50 {metrics['plan_step_p50_ms']:.2f} ms "
        f"({metrics['plan_steps']} ticks, {metrics['plan_restarts']} "
        f"restarts, {metrics['forced_drains']} forced drains); swap pause "
        f"{metrics['swap_pause_ms']:.1f} ms (synchronous rotation in phase "
        f"4: {sync_rotation_ms:.1f} ms); recovery {recover_s:.2f} s (restore"
        f" {restore_s:.2f}, replay {replay_s:.2f} of "
        f"{metrics['wal_replayed']} records, snapshot {save_s[-1]:.2f}); "
        f"peak memory {peak / 1e9:.2f} GB")
    return metrics


def drive_durable(torch, dev, R_host, cfg, stream, adds, rng, launch_counts,
                  reset_launch_counts) -> tuple:
    """The live half of phase 6: requests until the incremental swap, then
    the live state copied to the host and the server dropped.  Also keeps,
    on the host, the inputs of one plan slice and of one dirty-row batch
    (``check_plan_merge``)."""
    from repro_torch.bridge import state_to_numpy
    from repro_torch.core.rotation import unsorted_rows
    from repro_torch.serving import CFServer

    memory = {}

    def note_memory(tag: str) -> None:
        memory[tag] = (torch.cuda.memory_allocated() / 1e9,
                       torch.cuda.max_memory_allocated() / 1e9)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    note_memory("start")
    reset_launch_counts()
    srv = CFServer(R_host, cfg, device=dev)
    note_memory("built")
    add_ms: list[tuple[float, bool]] = []     # (ms, built the cache)
    adds = iter(adds)

    def add(user: int) -> None:
        item, value = next(adds)
        inits = len(srv.stats.cache_init_ms)
        ok = srv.add_rating(int(user), int(item), float(value))
        check_quiet(ok, f"add_rating({user}, {item}, {value}) applied")
        add_ms.append((srv.stats.add_rating_ms[-1],
                       len(srv.stats.cache_init_ms) > inits))

    def onboard(r) -> None:
        check_quiet(srv.onboard_user(r).ok, "onboard ok")

    reserve = CAPACITY_EXTRA // 4
    for i in range(CAPACITY_EXTRA - reserve):        # up to the reserve
        onboard(stream[i])
        if i == DUR_SNAPSHOT_EVERY // 2:
            for u in rng.choice(N_USERS, size=8, replace=False):
                add(u)                               # base rows
    note_memory("onboarded")
    check(srv.stats.snapshots == 2, "one mid-run checkpoint (and the "
          "construction's), the WAL truncated through it")
    i = CAPACITY_EXTRA - reserve
    onboard(stream[i])                               # the plan starts
    plan = srv._plan
    check(plan is not None and not plan.done and plan.k == i,
          f"incremental rotation in flight over a burst of {i}")
    for u in (5, 100, N_USERS - 1, 2 * DUR_BUDGET_ROWS + 7):
        add(u)                                       # base rows: dirty
    for u in srv.n_base + rng.choice(i, size=4, replace=False):
        add(u)                                       # burst rows: restart
    check(plan.restarts == 1, "a burst-row add_rating restarted the plan")
    del plan                     # the swap must free the accumulators
    note_memory("plan")
    for _ in range(3):
        srv.step_maintenance()
    dirty = sorted(int(u) for u in rng.choice(N_USERS, size=DUR_ADDS - 16,
                                              replace=False))
    for u in dirty:
        add(u)                                       # dirty rows, cache on
    # What the plan merges: the first slice of base rows, and the rows
    # just dirtied, each against the frozen burst block.
    st, n_base = srv.state, srv.n_base
    U = unsorted_rows(st.sim_vals, st.sim_idx, slice(n_base, n_base + i))
    rows = torch.as_tensor(dirty, device=dev)
    merge_inputs = {
        "n_base": n_base, "n_frozen": n_base + i,
        "slice": tuple(t.cpu() for t in (
            st.sim_vals[:DUR_BUDGET_ROWS], st.sim_idx[:DUR_BUDGET_ROWS],
            U[:, :DUR_BUDGET_ROWS])),
        "rows": tuple(t.cpu() for t in (st.sim_vals[rows], st.sim_idx[rows],
                                        U[:, rows]))}
    del st, U, rows
    while srv._plan is not None:
        i += 1
        onboard(stream[i])
    note_memory("swapped")
    check(srv.stats.rotations == 1 and not srv._plan,
          f"onboard {i + 1} completed the incremental swap")
    s = srv.stats
    stats = {"summary": s.summary(),
             "snapshot_save_ms": list(s.snapshot_save_ms),
             "wal_append_ms": list(s.wal_append_ms),
             "cache_init_ms": list(s.cache_init_ms),
             "plan_step_ms": list(s.plan_step_ms)}
    counts0 = launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = state_to_numpy(srv.state)
    live.update(to_host_s=time.perf_counter() - t0, n_base=srv.n_base,
                capacity=srv.state.capacity, generator=srv._gen.get_state())
    del srv, s
    torch.cuda.synchronize()
    note_memory("dropped")
    log("  device memory (allocated, peak so far) GB: " + ", ".join(
        f"{k} {a:.2f}/{p:.2f}" for k, (a, p) in memory.items()))
    check(memory["dropped"][0] < memory["start"][0] + 0.5,
          f"the dropped server released the card ({memory['dropped'][0]:.2f}"
          " GB allocated)")
    torch.cuda.empty_cache()
    return live, stats, add_ms, counts0, memory, merge_inputs


def check_plan_merge(torch, dev, inp) -> list[dict]:
    """The plan's merge at the shapes phase 6 gives it (a slice of
    ``DUR_BUDGET_ROWS`` base rows, and the dirty rows through the
    index-tensor branch; the replayed ``rotate_commit`` merges slices of
    that shape too), on the card and on the CPU (the plain version) from
    the same inputs: bit for bit.  Run after the phase's launch counts are
    read."""
    from repro_torch.core.rotation import merge_base_rows
    n_base, n_frozen = inp["n_base"], inp["n_frozen"]
    buf = torch.arange(n_base, n_frozen, dtype=torch.int32)
    out = []
    for branch in ("slice", "rows"):
        v, i, U = inp[branch]
        rows = (slice(0, v.shape[0]) if branch == "slice"
                else torch.arange(v.shape[0]))
        t0 = time.perf_counter()
        pv, pi = merge_base_rows(v, i, U, rows, buf, n_base=n_base)
        plain_s = time.perf_counter() - t0
        kv, ki = merge_base_rows(
            v.to(dev), i.to(dev), U.to(dev),
            rows if branch == "slice" else rows.to(dev), buf.to(dev),
            n_base=n_base)
        kv, ki = kv.cpu(), ki.cpu()
        err = float((kv - pv).abs().max())
        shape = [v.shape[0], v.shape[1], n_frozen - n_base]
        check(torch.equal(kv, pv) and torch.equal(ki, pi),
              f"plan merge ({branch}: {shape[0]} rows of width {shape[1]}, "
              f"k={shape[2]}) on the card bit-identical to the plain version"
              f" on the CPU (max diff {err:.3g}; plain {plain_s:.1f} s)")
        out.append({"branch": branch, "shape": shape, "max_abs_err": err,
                    "plain_cpu_s": plain_s})
    return out


# ---------------------------------------------------------------------------
# Phase 7: replication at Douban width
# ---------------------------------------------------------------------------

def mem_available_bytes() -> int:
    """The host's MemAvailable, from /proc/meminfo."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("MemAvailable not in /proc/meminfo")


def timed(fn, out: list):
    """``fn`` with each call's host milliseconds appended to ``out`` (for
    calls that end in a copy to the host or a sync of their own)."""
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            out.append((time.perf_counter() - t0) * 1e3)
    return wrapped


def states_equal(torch, a, b) -> bool:
    """Two states equal on all five leaves, compared on the card in slices
    of 4,096 rows."""
    if a.n_active != b.n_active:
        return False
    for x, y in zip(a[:4], b[:4]):
        if x.shape != y.shape or not all(
                torch.equal(x[r0:r0 + 4096], y[r0:r0 + 4096])
                for r0 in range(0, x.shape[0], 4096)):
            return False
    return True


def run_replication(torch, dev, R_host) -> dict:
    """A replicated server at Douban width (4 shards, r = 2, re-replication
    4,096 rows a tick): 12 onboards, then every similarity seam forbidden,
    node 1 killed (its replicas gone, its primary shard's 8,208 rows NaN),
    ``recommend_batch`` until the rows are healed and redundancy is back.
    The healed arena must equal a clone taken before the kill."""
    import numpy as np
    from repro_torch.core import clone_state
    from repro_torch.data.synthetic import plant_twins
    from repro_torch.distributed import ReplicationConfig, shard_row_slice
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (CFServer, LadderConfig, LEVEL_DEGRADED,
                                     ServerConfig)
    from repro_torch.testing import forbid_similarity_kernels, kill_replica
    from repro_torch.training.elastic import StragglerMonitor

    capacity = N_USERS + CAPACITY_EXTRA
    row_bytes = (DOUBAN_ITEMS + 1 + 2 * capacity) * 4
    arena_bytes = capacity * row_bytes
    # ``reset`` copies one shard's slice off the card while the replicas'
    # old copies are still held: REP_R copies plus the largest shard.
    shard = shard_row_slice(capacity, REP_SHARDS, REP_SHARDS - 1)
    need = REP_R * arena_bytes + (shard.stop - shard.start) * row_bytes
    avail = mem_available_bytes()
    check(avail > need, f"host MemAvailable {avail / 1e9:.1f} GB holds "
          f"{REP_R} replica copies of the {arena_bytes / 1e9:.2f} GB arena "
          f"plus one shard's slice ({need / 1e9:.1f} GB)")
    rng = np.random.default_rng(SEED + 20)
    heavy = np.flatnonzero((R_host != 0).sum(axis=1) >= 50)
    stream = [R_host[int(u)].astype(np.float32)
              for u in rng.choice(heavy, size=REP_ONBOARDS // 2,
                                  replace=False)]
    stream += [plant_twins(R_host, 1, seed=SEED + 700 + i)[0].astype(
        np.float32) for i in range(REP_ONBOARDS - len(stream))]
    stream = [stream[i] for i in rng.permutation(len(stream))]
    users = rng.choice(N_USERS, size=KNN_B, replace=False).tolist()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    reset_launch_counts()
    t0 = time.perf_counter()
    srv = CFServer(R_host, ServerConfig(
        capacity_extra=CAPACITY_EXTRA, c_probes=C_PROBES,
        replication=ReplicationConfig(n_shards=REP_SHARDS, r=REP_R,
                                      rebuild_rows=REP_REBUILD_ROWS),
        ladder=LadderConfig(monitor=StragglerMonitor(
            window=64, straggler_ratio=50.0, hang_timeout_s=30.0,
            consecutive_to_shrink=3))), device=dev)
    build_s = time.perf_counter() - t0
    reps = srv.replicas
    host_gb = sum(a.nbytes for rep in reps._replicas.values()
                  for a in rep.data.values()) / 1e9
    apply_ms, repair_ms, rebuild_ms, pre_query_ms = [], [], [], []
    reps.apply_rows = timed(reps.apply_rows, apply_ms)
    results = [srv.onboard_user(r) for r in stream]
    check(all(r.ok for r in results), f"{len(results)} onboards ok "
          f"({sum(r.twin_found for r in results)} twin hits)")
    reset_s = srv.stats.replica_reset_ms[0] / 1e3   # the construction's
    before = srv.recommend_batch(users, n=10, k_neighbors=20)
    good = clone_state(srv.state)

    forbid_similarity_kernels(srv)
    seams = ("_onboard", "_onboard_trad", "_init_cache", "_add",
             "_refresh_cache")
    called: list[str] = []

    def tripwire(name, fn):
        def wrapped(*args, **kwargs):
            called.append(name)
            return fn(*args, **kwargs)
        return wrapped

    for name in seams:
        setattr(srv, name, tripwire(name, getattr(srv, name)))
    reps.repair = timed(reps.repair, repair_ms)
    reps.step_rebuild = timed(reps.step_rebuild, rebuild_ms)
    rebuilt0 = reps.rebuilt_rows
    lost = kill_replica(srv, 1)
    levels, answers = [], []
    while srv.stats.repairs == 0 or reps.degraded():
        check_quiet(len(levels) < 64, "healed within 64 reads")
        answers.append(srv.recommend_batch(users, n=10, k_neighbors=20))
        levels.append(srv.level)
    rebuilt = reps.rebuilt_rows - rebuilt0
    counts = launch_counts()
    srv._pre_query = timed(srv._pre_query, pre_query_ms)
    read_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        srv.recommend_batch(users, n=10, k_neighbors=20)
        read_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()

    log(f"  built in {build_s:.1f} s (replicas {host_gb:.2f} GB on the "
        f"host); killed node 1: {lost.size} primary rows poisoned; "
        f"{len(levels)} reads until healed and redundant, levels {levels}")
    check(states_equal(torch, srv.state, good),
          "healed primary equal to the state before the kill on all five "
          "leaves")
    check(all(a == before for a in answers),
          f"every read after the kill answered as before it ({KNN_B} users)")
    check(srv.stats.repairs >= 1 and srv.stats.rollbacks == 0,
          f"healed from replicas ({srv.stats.repairs} repair(s), "
          f"{reps.repaired_rows} rows), no rollback")
    check(LEVEL_DEGRADED in levels and srv.level < LEVEL_DEGRADED
          and reps.redundancy() == REP_R,
          f"ladder went to degraded and back down ({srv.level}); "
          f"redundancy {reps.redundancy()}")
    check(not called, f"no similarity seam called ({called})")
    check(counts["similarity"] == 0 and counts["knn_score"] > 0,
          f"launches in this phase: {counts}")
    del good
    srv_stats = srv.stats.summary()
    # The timers hold bound methods: drop them, so that dropping the server
    # checks the server's own references, not the smoke's.
    del srv._pre_query, reps.apply_rows, reps.repair, reps.step_rebuild
    del srv, reps
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    end_gb = torch.cuda.memory_allocated() / 1e9
    check(end_gb < start_gb + 0.5, f"the dropped server released the card "
          f"({end_gb:.2f} GB allocated)")

    arena_gb = arena_bytes / 1e9
    metrics = {
        "shards": REP_SHARDS, "r": REP_R, "rebuild_rows": REP_REBUILD_ROWS,
        "build_s": build_s, "replica_host_gb": host_gb,
        "mem_available_gb": avail / 1e9,
        "reset_s": reset_s, "reset_gb_s": arena_gb / reset_s,
        "apply_rows_p50_ms": pct(apply_ms, 0.5),
        "apply_rows_p99_ms": pct(apply_ms, 0.99),
        "repair_ms": repair_ms, "repaired_rows": lost.size,
        "rebuild_rows_per_s": rebuilt / (sum(rebuild_ms) / 1e3),
        "rebuilt_rows": rebuilt, "rebuild_ticks_ms": rebuild_ms,
        "pre_query_ms": pre_query_ms, "read_ms": read_ms,
        "reads_to_heal": len(levels), "levels": levels,
        "repairs": srv_stats["repairs"], "twin_hits": srv_stats["twin_hits"],
        "peak_gb": peak / 1e9, "launches": counts}
    log(f"  reset {reset_s:.2f} s ({metrics['reset_gb_s']:.2f} GB/s); "
        f"apply_rows per onboard p50 {metrics['apply_rows_p50_ms']:.3f} ms "
        f"p99 {metrics['apply_rows_p99_ms']:.3f} ms; repair "
        f"{', '.join(f'{t:.1f}' for t in repair_ms)} ms for {lost.size} rows;"
        f" re-replication {metrics['rebuild_rows_per_s']:.0f} rows/s "
        f"({rebuilt} rows); health check before each read batch "
        f"{', '.join(f'{t:.1f}' for t in pre_query_ms)} ms (reads "
        f"{', '.join(f'{t:.1f}' for t in read_ms)} ms); peak "
        f"{peak / 1e9:.2f} GB")
    return metrics


# ---------------------------------------------------------------------------
# Phase 8: the buffered burst at Douban width
# ---------------------------------------------------------------------------

def buffered_burst(R_host, n_copies: int = 16, n_fresh: int = 8,
                   n_repeats: int = 8, seed: int = SEED + 30):
    """A burst of ``n_copies`` rows copied from heavy base users,
    ``n_fresh`` fresh profiles and ``n_repeats`` repeats of the first
    fresh ones, each repeat after its original (phase 8: 16, 8, 8).
    Returns the rows and, per row, the base source or the burst index of
    the original."""
    import numpy as np
    from repro_torch.data.synthetic import plant_twins
    rng = np.random.default_rng(seed)
    heavy = np.flatnonzero((R_host != 0).sum(axis=1) >= 50)
    base = rng.choice(heavy, size=n_copies, replace=False)
    items = [("base", int(u)) for u in base]
    items += [("fresh", i) for i in range(n_fresh)]
    keys = list(rng.random(len(items)))
    for i in range(n_repeats):               # a repeat follows its original
        k0 = keys[n_copies + i]
        items.append(("repeat", i))
        keys.append(k0 + (1.0 - k0) * rng.random())
    order = np.argsort(keys, kind="stable")
    fresh = [plant_twins(R_host, 1, seed=SEED + 800 + i)[0]
             for i in range(n_fresh)]
    rows, kinds, first = [], [], {}
    for pos, j in enumerate(order):
        kind, v = items[j]
        rows.append(R_host[v] if kind == "base" else fresh[v])
        if kind == "fresh":
            first[v] = pos
        kinds.append((kind, v if kind == "base" else first.get(v)))
    return np.stack(rows).astype(np.float32), kinds


def run_buffered(torch, dev, R_host, trad_burst_ms: float) -> dict:
    """``onboard_batch_buffered(maintain=True)`` over the phase-4 ratings'
    base state (32,768 users, capacity 32,768): the flags against the
    burst's construction, the 32 lists against the traditional burst on
    the card, and a 4,096-row slice of the maintained base lists against
    the plain merge on the CPU, bit for bit."""
    import numpy as np
    from repro_torch.bridge import lists_match
    from repro_torch.core import (CFState, build_state,
                                  onboard_batch_buffered,
                                  onboard_batch_traditional, set0_cap)
    from repro_torch.core.knn import SORT_CHUNK_ROWS
    from repro_torch.core.maintenance import merge_new_users_into_base
    from repro_torch.core.rotation import unsorted_rows
    from repro_torch.core.twinsearch import make_probes
    from repro_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    base = build_state(torch.as_tensor(R_host).to(dev), capacity_extra=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    N = base.capacity
    burst, kinds = buffered_burst(R_host)
    k = burst.shape[0]
    probes = make_probes(torch.Generator().manual_seed(SEED + 31), k,
                         C_PROBES, N)
    R_new = torch.as_tensor(burst, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    vals, idx, stats, (mv, mi) = onboard_batch_buffered(
        base, R_new, probes, s_max=set0_cap(N), maintain=True)
    torch.cuda.synchronize()
    burst_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    found = stats.found.cpu().numpy()
    twin = stats.twin_idx.cpu().numpy()
    expect = np.array([kind != "fresh" for kind, _ in kinds])
    check(np.array_equal(found, expect),
          f"flags match the burst: {int(found.sum())} twins found "
          f"(16 base copies, 8 repeats), {int((~found).sum())} fresh")
    check(all(twin[t] == N + v if kind == "repeat"
              else np.array_equal(R_host[twin[t]], burst[t])
              for t, (kind, v) in enumerate(kinds) if kind != "fresh"),
          "base twins verify against their rows, repeats name the first "
          "earlier copy (N_base + position)")
    check(counts["list_merge"] > 0, f"kernel list_merge launched "
          f"{counts['list_merge']} times in the buffered burst ({counts})")

    # The merge alone, on the inputs the path gave it (the write buffer's
    # base columns, recovered from the sorted rows): timed, and equal to
    # the path's output.
    U = unsorted_rows(vals, idx, slice(0, k))[:, :N]
    ids = N + torch.arange(k, device=dev)
    merge_ms = cuda_ms(lambda: merge_new_users_into_base(
        base.sim_vals, base.sim_idx, U, ids), reps=3)
    again = merge_new_users_into_base(base.sim_vals, base.sim_idx, U, ids)
    check(torch.equal(again[0], mv) and torch.equal(again[1], mi),
          "the merge on the recovered buffer equals the path's output")
    del again
    once = all(bool(((mi == N + t).sum(dim=1) == 1).all()) for t in range(k))
    check(once and mv.shape == (N, N + k), f"each new user once in every "
          f"maintained base row ({tuple(mv.shape)})")
    rows = slice(0, SORT_CHUNK_ROWS)
    t0 = time.perf_counter()
    pv, pi = merge_new_users_into_base(base.sim_vals[rows].cpu(),
                                       base.sim_idx[rows].cpu(),
                                       U[:, rows].cpu(), ids.cpu())
    plain_s = time.perf_counter() - t0
    check(torch.equal(mv[rows].cpu(), pv) and torch.equal(mi[rows].cpu(), pi),
          f"maintained base rows 0-{SORT_CHUNK_ROWS - 1} bit-identical to the "
          f"plain merge on the CPU ({plain_s:.1f} s)")
    del mv, mi, pv, pi
    # A base twin's row is its twin's stored list (the twin path is data
    # movement), bit for bit.
    copies = [t for t, (kind, _) in enumerate(kinds) if kind == "base"]
    computed = [t for t, (kind, _) in enumerate(kinds) if kind != "base"]
    stored = unsorted_rows(base.sim_vals, base.sim_idx,
                           stats.twin_idx[copies])
    check(torch.equal(U[copies], stored), f"the {len(copies)} base twins' "
          "rows equal their twins' stored lists, bit for bit")
    del U, stored

    # The traditional burst of the same users on the card: an arena of
    # capacity N + k over the same ratings.  Its products are
    # multiply-then-divide, as the buffered path's for fresh users and
    # repeats; a twin's copied list comes from the build, which normalises
    # first, so those rows are held to the copy above instead.
    trad = CFState(torch.cat([base.ratings, torch.zeros(
        (k, base.n_items), device=dev)]), torch.cat([base.norms, torch.zeros(
            k, device=dev)]), torch.empty((N + k, N + k), device=dev),
        torch.empty((N + k, N + k), dtype=torch.int32, device=dev), N)
    del base
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trad = onboard_batch_traditional(trad, R_new)
    torch.cuda.synchronize()
    trad_ms = (time.perf_counter() - t0) * 1e3
    tv, ti = trad.sim_vals[N:], trad.sim_idx[N:]
    why = lists_match(tv[computed].cpu().numpy(), ti[computed].cpu().numpy(),
                      vals[computed].cpu().numpy(),
                      idx[computed].cpu().numpy(), 1e-6)
    check(why is None, f"the {len(computed)} fresh and repeated users' lists "
          f"equal the traditional burst's within 1e-6, ids except near ties "
          f"({why})")
    dense_t = unsorted_rows(tv, ti, slice(0, k))[copies]
    dense_b = unsorted_rows(vals, idx, slice(0, k))[copies]
    burst_err = float((dense_t[:, N:] - dense_b[:, N:]).abs().max())
    copy_err = float((dense_t[:, :N] - dense_b[:, :N]).abs().max())
    check(burst_err <= 1e-6, f"the base twins' entries for the burst's "
          f"users within 1e-6 of the traditional burst's ({burst_err:.3g})")
    log(f"  the base twins' copied lists against the traditional burst's own "
        f"products: max diff {copy_err:.3g} (the build normalises first)")
    del trad, tv, ti, dense_t, dense_b
    torch.cuda.empty_cache()
    metrics = {"k": k, "n_base": N, "c": C_PROBES, "build_s": build_s,
               "burst_ms": burst_ms, "merge_ms": merge_ms,
               "merge_shape": [N, N + k, k], "plain_slice_cpu_s": plain_s,
               "traditional_burst_ms": trad_ms,
               "phase4_traditional_burst_ms": trad_burst_ms,
               "peak_gb": peak / 1e9, "launches": counts,
               "twins": int(found.sum()), "twin_copy_vs_traditional_max_diff":
               copy_err, "burst_entries_max_diff": burst_err}
    log(f"  base built in {build_s:.1f} s; buffered burst of {k} "
        f"(maintain=True) {burst_ms:.1f} ms, of which the merge "
        f"({N} x {N + k}, {counts['list_merge']} launches) {merge_ms:.2f} ms;"
        f" traditional burst of the same users {trad_ms:.1f} ms (phase 4: "
        f"{trad_burst_ms:.1f} ms); peak {peak / 1e9:.2f} GB")
    return metrics


# ---------------------------------------------------------------------------
# Phase 9: the CF model family and the sharded burst at Douban width
# ---------------------------------------------------------------------------

class CollectiveBytes:
    """Wraps ``torch.distributed``'s collectives while it is active and
    records, per call, the bytes of the tensor it is called with (a
    gather: its output), its element count and dtype."""

    NAMES = ("all_reduce", "all_gather_into_tensor")

    def __init__(self, dist):
        self.dist, self.calls, self._saved = dist, [], {}

    def __enter__(self):
        for name in self.NAMES:
            self._saved[name] = fn = getattr(self.dist, name)
            setattr(self.dist, name, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.dist, name, fn)

    def _wrap(self, fn):
        def counted(tensor, *args, **kwargs):
            self.calls.append((tensor.numel() * tensor.element_size(),
                               tensor.numel(), tensor.dtype))
            return fn(tensor, *args, **kwargs)
        return counted

    def per_user(self, torch, c: int) -> list[int]:
        """Bytes per user: each user's first collective is the sum of its
        c float32 probe sims, the only float32 call of c entries."""
        users = []
        for nbytes, numel, dtype in self.calls:
            if numel == c and dtype == torch.float32:
                users.append(0)
            users[-1] += nbytes
        return users


def sparse_rows_product(torch, Rn, rows: slice):
    """The plain computation of ``Rn[rows] @ Rn.T`` on the CPU, fp32,
    from the nonzeros of ``Rn`` (the ratings are 0.2% dense, so a sparse
    product takes seconds where a dense one on the host would take about
    a minute).  Each term is a product of two bf16 values, exact in fp32;
    only the order of the sums differs from the card's."""
    nz = torch.nonzero(Rn, as_tuple=True)
    vals = Rn[nz].float().cpu()
    r, c = nz[0].cpu(), nz[1].cpu()
    n, m = Rn.shape
    keep = (r >= rows.start) & (r < rows.stop)
    A = torch.sparse_coo_tensor(torch.stack([r[keep] - rows.start,
                                             c[keep]]), vals[keep],
                                (rows.stop - rows.start, m),
                                check_invariants=False).to_sparse_csr()
    Bt = torch.sparse_coo_tensor(torch.stack([c, r]), vals, (m, n),
                                 check_invariants=False).to_sparse_csr()
    return (A @ Bt).to_dense()


def run_cf_family(torch, dev, R_host, buffered_ms: float) -> dict:
    """The ``twinsearch-cf`` architecture's two step kinds at Douban width,
    through ``models.cf``: ``build_step`` on the bf16 ratings that
    ``input_structs("douban_build")`` asks for (the similarity kernel),
    and ``onboard_step`` on a one-rank NCCL process group, the sharded
    burst (``maintain`` False and True: the list_merge kernel), each held
    to a plain computation.  Then ``onboard_batch_resilient`` and
    ``build_step`` at MovieLens shape and ``serve_cf`` at its defaults."""
    import dataclasses
    import numpy as np
    import torch.distributed as dist
    from repro_torch.bridge import lists_match
    from repro_torch.configs import get_arch
    from repro_torch.core import build_state, onboard_batch_buffered, set0_cap
    from repro_torch.core import twinsearch_sharded as tsh
    from repro_torch.core.knn import SORT_CHUNK_ROWS
    from repro_torch.core.maintenance import merge_new_users_into_base
    from repro_torch.core.rotation import unsorted_rows
    from repro_torch.core.twinsearch import make_probes
    from repro_torch.distributed import local_state
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import cf

    t_phase = time.perf_counter()
    spec = get_arch("twinsearch-cf")
    build_dtype = cf.input_structs(spec.config,
                                   spec.shape("douban_build"))["R"].dtype
    onb = cf.input_structs(spec.config, spec.shape("douban_onboard"))
    k, c = onb["R_new"].shape[0], onb["probes"].shape[1]
    # The registered config's sim_tol is 0.0; the main drive takes the
    # server's 1e-6 (ServerConfig.sim_tol), and 0.0 is run once below.
    cfg = dataclasses.replace(spec.config, sim_tol=1e-6)
    N, m = R_host.shape

    base = build_state(torch.as_tensor(R_host, device=dev).float(),
                       capacity_extra=0)
    burst, kinds = buffered_burst(R_host, n_copies=k // 2, n_fresh=8,
                                  n_repeats=k - k // 2 - 8, seed=SEED + 40)
    R_new = torch.as_tensor(burst, device=dev).to(onb["R_new"].dtype)
    probes = make_probes(torch.Generator().manual_seed(SEED + 41), k, c, N)
    s_max = set0_cap(N, cfg.set0_divisor, cfg.set0_slack)
    R_b = torch.as_tensor(R_host, device=dev).to(build_dtype)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device(
                                "cuda", torch.cuda.current_device()))
    try:
        mesh_info = (("data", "model"), make_mesh((1, 1), ("data", "model")))
        local = local_state(base, 0, dist.get_world_size())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # The main path, counted: the build, then the burst both ways.
        reset_launch_counts()
        t0 = time.perf_counter()
        vals, idx = cf.build_step(R_b)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = cf.onboard_step(local, R_new, probes, cfg, mesh_info=mesh_info)
        torch.cuda.synchronize()
        sharded_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        outm = tsh.onboard_batch_sharded(local, R_new, probes, s_max=s_max,
                                         tol=cfg.sim_tol, maintain=True)
        torch.cuda.synchronize()
        sharded_m_ms = (time.perf_counter() - t0) * 1e3
        counts = launch_counts()
        check(counts["similarity"] >= 1 and counts["list_merge"] >= 1,
              f"kernels similarity (build_step) and list_merge (the sharded "
              f"burst's merge) launched in this phase ({counts})")

        metrics = check_cf_build(torch, dev, R_b, vals, idx, build_s)
        del vals, idx
        torch.cuda.empty_cache()

        # The sharded burst against the buffered burst on the same inputs.
        found = out[2].found.cpu().numpy()
        expect = np.array([kind != "fresh" for kind, _ in kinds])
        check(np.array_equal(found, expect),
              f"sharded burst flags match the burst: {int(found.sum())} "
              f"twins of {k} ({k // 2} base copies, {k - k // 2 - 8} "
              "repeats), 8 fresh")
        ref = onboard_batch_buffered(base, R_new, probes, s_max=s_max,
                                     tol=cfg.sim_tol)
        flags = all(torch.equal(getattr(got[2], f), getattr(ref[2], f))
                    for got in (out, outm)
                    for f in ("found", "twin_idx", "n_candidates",
                              "overflowed"))
        whys = [lists_match(ref[0].cpu().numpy(), ref[1].cpu().numpy(),
                            got[0].cpu().numpy(), got[1].cpu().numpy(), 2e-5)
                for got in (out, outm)]
        same = torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
        check(flags and whys == [None, None], f"sharded burst (both maintain "
              f"values) = buffered burst on the same inputs: found, "
              f"twin_idx, n_candidates, overflowed exact; lists within 2e-5 "
              f"(bit for bit: {same}; {whys})")
        del ref
        mv, mi = outm[3]
        once = all(bool(((mi == N + t).sum(dim=1) == 1).all())
                   for t in range(k))
        check(once and mv.shape == (N, N + k), f"each new user once in every "
              f"maintained base row ({tuple(mv.shape)})")
        U = unsorted_rows(outm[0], outm[1], slice(0, k))[:, :N]
        rows = slice(0, SORT_CHUNK_ROWS)
        pv, pi = merge_new_users_into_base(
            base.sim_vals[rows].cpu(), base.sim_idx[rows].cpu(),
            U[:, rows].cpu(), (N + torch.arange(k)))
        check(torch.equal(mv[rows].cpu(), pv) and torch.equal(mi[rows].cpu(),
                                                              pi),
              f"maintained base rows 0-{SORT_CHUNK_ROWS - 1} bit-identical "
              "to the plain merge on the CPU")
        refm = onboard_batch_buffered(base, R_new, probes, s_max=s_max,
                                      tol=cfg.sim_tol, maintain=True)
        check(torch.equal(refm[3][0], mv) and torch.equal(refm[3][1], mi),
              "the maintained lists equal the buffered burst's, bit for bit")
        del refm, mv, mi, pv, pi, U, outm
        torch.cuda.empty_cache()

        # Both bursts again on the same inputs, in turns (buffered,
        # sharded, sharded, buffered) for each maintain value, each call
        # ending in a sync.
        def burst_ms(fn, maintain):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(base if fn is onboard_batch_buffered else local, R_new,
                     probes, s_max=s_max, tol=cfg.sim_tol, maintain=maintain)
            torch.cuda.synchronize()
            del res
            return (time.perf_counter() - t0) * 1e3

        turns = {}
        for maintain in (False, True):
            order = (onboard_batch_buffered, tsh.onboard_batch_sharded,
                     tsh.onboard_batch_sharded, onboard_batch_buffered)
            ms = [burst_ms(fn, maintain) for fn in order]
            turns[f"maintain_{str(maintain).lower()}"] = {
                "buffered_ms": [ms[0], ms[3]], "sharded_ms": [ms[1], ms[2]]}
            log(f"  maintain={maintain} in turns: buffered {ms[0]:.1f}, "
                f"sharded {ms[1]:.1f}, sharded {ms[2]:.1f}, buffered "
                f"{ms[3]:.1f} ms")

        # Collective bytes per user, counted by wrapping the collectives.
        with CollectiveBytes(dist) as cb:
            _, _, st = tsh.onboard_batch_sharded(local, R_new, probes,
                                                 s_max=s_max,
                                                 tol=cfg.sim_tol)
        per_user = cb.per_user(torch, c)
        branch = ["fallback" if not f else ("base" if t < N else "new")
                  for f, t in zip(st.found.tolist(), st.twin_idx.tolist())]
        check(len(per_user) == k and all(
            b == tsh.payload_bytes(N, c, br)
            for b, br in zip(per_user, branch)),
              "collective bytes of each user = payload_bytes (docstring)")
        base_bytes = sorted({b for b, br in zip(per_user, branch)
                             if br == "base"})
        log(f"  collective bytes per user: base twin {base_bytes} "
            f"((2c+2)·N·4 = {(2 * c + 2) * N * 4}; the reference's claim "
            f"(c+2)·N·4 = {(c + 2) * N * 4}); fallback "
            f"{tsh.payload_bytes(N, c, 'fallback')}, burst twin "
            f"{tsh.payload_bytes(N, c, 'new')}")

        # The registered config's tolerance, 0.0, on the same inputs.
        out0 = cf.onboard_step(local, R_new, probes, spec.config,
                               mesh_info=mesh_info)
        ref0 = onboard_batch_buffered(base, R_new, probes, s_max=s_max,
                                      tol=spec.config.sim_tol)
        check(all(torch.equal(getattr(out0[2], f), getattr(ref0[2], f))
                  for f in ("found", "twin_idx", "n_candidates",
                            "overflowed")),
              f"at the registered sim_tol {spec.config.sim_tol}: flags = "
              f"buffered burst's; {int(out0[2].found.sum())} twins found, "
              f"{int((out0[2].found & (out0[2].twin_idx < N)).sum())} of "
              "them base twins")
        tol0_base = int((out0[2].found & (out0[2].twin_idx < N)).sum())
        del out0, ref0, out, local
        peak = torch.cuda.max_memory_allocated()
        del base, R_b
        torch.cuda.empty_cache()

        resilient = check_cf_resilient(torch, dev)
    finally:
        dist.destroy_process_group()
    ml = check_ml_build(torch, dev)
    served = check_serve_cf(torch)
    metrics.update({
        "k": k, "c": c, "n_base": N, "sim_tol": cfg.sim_tol,
        "sharded_first_ms": {"maintain_false": sharded_ms,
                             "maintain_true": sharded_m_ms},
        "turns": turns, "phase8_buffered_burst_ms": buffered_ms,
        "collective_bytes_per_user": {
            "base_twin": base_bytes, "formula_2c_plus_2": (2 * c + 2) * N * 4,
            "reference_claim_c_plus_2": (c + 2) * N * 4,
            "fallback": tsh.payload_bytes(N, c, "fallback"),
            "burst_twin": tsh.payload_bytes(N, c, "new")},
        "registered_sim_tol_base_twins": tol0_base,
        "twins": int(found.sum()), "peak_gb": peak / 1e9,
        "launches": counts, "resilient": resilient, "ml_build": ml,
        "serve_cf": served})
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  build_step {build_s:.3f} s (torch.mm(out_dtype=float32) on the "
        f"padded rows {metrics['build_kernel']['library_ms'] / 1e3:.3f} s, "
        f"torch.matmul "
        f"of the fp32 copies {metrics['matmul_s']:.2f} s); sharded burst of "
        f"{k}, first calls: "
        f"{sharded_ms:.1f} ms, maintain=True {sharded_m_ms:.1f} ms (phase "
        f"8's buffered burst of 32: {buffered_ms:.1f} ms); peak "
        f"{peak / 1e9:.2f} GB; phase {metrics['phase_s']:.1f} s")
    return metrics


def check_cf_build(torch, dev, R_b, vals, idx, build_s: float) -> dict:
    """``build_step``'s lists against a plain computation on the CPU for
    a 4,096-row slice (within 1e-5, ids except near-ties); then its three
    parts timed apart by CUDA events on the same inputs (the normalisation
    into the kernel's aligned buffer, the similarity launch, the sort
    slices), the launch twice around ``torch.mm(Rn, Rn.T,
    out_dtype=torch.float32)`` on the whole zero-padded buffer (the
    library's call for the same function: bf16 operands, fp32 sums), then
    that call once on the odd-depth view the kernel reads (which cuBLAS
    takes more slowly) and ``torch.matmul`` of fp32 copies, TF32 off."""
    from repro_torch.bridge import lists_match
    from repro_torch.core.knn import SORT_CHUNK_ROWS, sort_rows
    from repro_torch.core.similarity import EPS, row_norms
    from repro_torch.kernels.similarity.kernel import (row_buffer,
                                                       similarity_cuda)
    N, m = R_b.shape
    rows = slice(0, SORT_CHUNK_ROWS)

    def events_ms(fn):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def normalise():
        Rf = R_b.float()
        return torch.div(Rf, torch.clamp_min(row_norms(Rf), EPS)[:, None],
                         out=row_buffer(N, m, R_b.dtype, dev))

    Rn, norm_ms = events_ms(normalise)
    t0 = time.perf_counter()
    pv, pi = sort_rows(sparse_rows_product(torch, Rn, rows))
    plain_s = time.perf_counter() - t0
    why = lists_match(pv.numpy(), pi.numpy(), vals[rows].cpu().numpy(),
                      idx[rows].cpu().numpy(), 1e-5)
    err = float((vals[rows].cpu() - pv).abs().max())
    check(why is None, f"build_step rows 0-{SORT_CHUNK_ROWS - 1} within 1e-5 "
          f"of the plain computation on the CPU, ids except near ties "
          f"(max sorted diff {err:.3g}; {plain_s:.1f} s; {why})")
    del pv, pi
    ones = torch.ones(N, device=dev)
    kernel = lambda: similarity_cuda(Rn, Rn, ones, ones)      # noqa: E731
    Rp = padded_rows(Rn)
    library = lambda: torch.mm(Rp, Rp.T,                      # noqa: E731
                               out_dtype=torch.float32)
    turns = []
    for fn in (kernel, library, kernel,
               lambda: torch.mm(Rn, Rn.T, out_dtype=torch.float32)):
        S, ms = events_ms(fn)
        turns.append(ms)
        del S
    kernel_ms, lib_ms, lib_odd_ms = (turns[0] + turns[2]) / 2, *turns[1::2]
    del Rp

    def sort_slices():
        idx = torch.empty(S.shape, dtype=torch.int32, device=dev)
        for r0 in range(0, N, SORT_CHUNK_ROWS):
            sl = slice(r0, r0 + SORT_CHUNK_ROWS)
            S[sl], idx[sl] = sort_rows(S[sl])
        return idx

    S = kernel()
    _, sort_ms = events_ms(sort_slices)
    del S, _
    torch.backends.cuda.matmul.allow_tf32 = False
    Rf = Rn.float()
    del Rn
    S, matmul_ms = events_ms(lambda: torch.matmul(Rf, Rf.T))
    del S, Rf
    torch.cuda.empty_cache()
    # The operations over the peak rate of the inputs' type: bf16 on the
    # tensor cores, where the kernel multiplies them.
    flops = 2.0 * N * N * m
    rate = (BF16_FLOPS_PER_S if R_b.dtype == torch.bfloat16
            else FP32_FLOPS_PER_S)
    moved = 2.0 * R_b.element_size() * N * m + 4.0 * 2 * N + 4.0 * N * N
    b_ms, b_by = bound(moved, flops, rate)
    log(f"  build_step ({N} x {m}, {R_b.dtype}): {build_s:.3f} s; on the "
        f"same inputs: normalisation {norm_ms:.1f} ms, its similarity launch "
        f"{kernel_ms:.1f} ms ({turns[0]:.1f}, {turns[2]:.1f}; "
        f"{b_ms / kernel_ms:.0%} of the bound, {b_ms:.1f} ms, {b_by}), the "
        f"sort slices {sort_ms:.1f} ms; torch.mm(out_dtype=float32) on the "
        f"padded buffer {lib_ms:.1f} ms, on the odd-depth view "
        f"{lib_odd_ms:.1f} ms; torch.matmul of fp32 copies "
        f"{matmul_ms:.1f} ms")
    return {"build_s": build_s, "matmul_s": matmul_ms / 1e3,
            "build_kernel": {"shape": [N, N, m], "dtype": str(R_b.dtype),
                             "ms": kernel_ms, "turns_ms": turns,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": lib_ms,
                             "library_odd_depth_ms": lib_odd_ms,
                             "matmul_f32_copies_ms": matmul_ms,
                             "normalise_ms": norm_ms, "sort_ms": sort_ms,
                             "max_abs_err_slice": err},
            "plain_slice_cpu_s": plain_s}


def check_cf_resilient(torch, dev) -> dict:
    """``onboard_batch_resilient`` at MovieLens shape: a NaN row healed
    from the replicas bit for bit, and the burst equal to the sharded
    burst on the clean arena."""
    import numpy as np
    from repro_torch.core import build_state, set0_cap
    from repro_torch.core import twinsearch_sharded as tsh
    from repro_torch.core.twinsearch import make_probes
    from repro_torch.data.synthetic import movielens_100k, plant_twins
    from repro_torch.distributed import (ReplicatedArena, ReplicationConfig,
                                         local_state)
    from repro_torch.serving.guard import RetryPolicy
    R = movielens_100k(SEED).astype(np.float32)
    n = R.shape[0]
    st = build_state(torch.as_tensor(R, device=dev))
    burst = np.stack([R[11], plant_twins(R, 1, seed=SEED + 60)[0], R[11],
                      R[400]]).astype(np.float32)
    probes = make_probes(torch.Generator().manual_seed(SEED + 61),
                         burst.shape[0], C_PROBES, n)
    want = tsh.onboard_batch_sharded(local_state(st, 0, 1),
                                     torch.as_tensor(burst), probes,
                                     s_max=set0_cap(n))
    clean = [t.clone() for t in st[:4]]
    replicas = ReplicatedArena(st, ReplicationConfig(n_shards=4, r=2))
    st.sim_vals[5] = float("nan")
    t0 = time.perf_counter()
    healed, got = tsh.onboard_batch_resilient(
        st, torch.as_tensor(burst), probes, s_max=set0_cap(n),
        replicas=replicas, retry=RetryPolicy())
    ms = (time.perf_counter() - t0) * 1e3
    check(replicas.repaired_rows == 1 and all(
        torch.equal(a, b) for a, b in zip(healed[:4], clean)),
          "onboard_batch_resilient at MovieLens shape healed the NaN row, "
          "bit for bit")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
          and torch.equal(got[2].found, want[2].found),
          "the resilient burst equals the sharded burst on the clean arena")
    return {"ms": ms, "repaired_rows": replicas.repaired_rows}


def check_ml_build(torch, dev) -> dict:
    """``build_step`` at ``ml_build`` (943 x 1,682), full size, in bf16 (the
    config's input dtype) and f32: the card against the CPU, within 1e-5."""
    import numpy as np
    from repro_torch.bridge import lists_match
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import movielens_100k
    from repro_torch.models import cf
    spec = get_arch("twinsearch-cf")
    shape = spec.shape("ml_build")
    R = movielens_100k(SEED).astype(np.float32)
    check_quiet(R.shape == (shape.dim("n_users"), shape.dim("n_items")),
                "ml_build shape")
    errs = {}
    for dtype in (cf.input_structs(spec.config, shape)["R"].dtype,
                  torch.float32):
        cv, ci = cf.build_step(torch.as_tensor(R, device=dev).to(dtype))
        pv, pi = cf.build_step(torch.as_tensor(R).to(dtype))
        why = lists_match(pv.numpy(), pi.numpy(), cv.cpu().numpy(),
                          ci.cpu().numpy(), 1e-5)
        errs[str(dtype)] = float((cv.cpu() - pv).abs().max())
        check(why is None, f"build_step at ml_build {R.shape} in {dtype}: "
              f"card = CPU within 1e-5, ids except near ties (max diff "
              f"{errs[str(dtype)]:.3g}; {why})")
    return errs


def check_serve_cf(torch) -> dict:
    """``repro_torch.launch.serve.serve_cf`` once, in this process, at its
    defaults (2,000 users x 800 items, on the card)."""
    from repro_torch.launch import serve
    args = serve.parser().parse_args([])
    t0 = time.perf_counter()
    srv = serve.serve_cf(args)
    s = srv.stats.summary()
    check(args.device == "cuda" and srv.state.ratings.is_cuda
          and s["twin_hits"] == s["onboarded"] == 8,
          f"serve_cf at its defaults ({args.users} x {args.items}) on the "
          f"card: {s['twin_hits']} of 8 planted twins found")
    out = {"s": time.perf_counter() - t0, "twin_hits": s["twin_hits"],
           "onboard_p50_ms": s["onboard_p50_ms"]}
    del srv
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 10: the recsys family and the training substrate
# ---------------------------------------------------------------------------

# serve_bulk runs in slices: one call would hold the CIN's (262,144,
# 200·39, 10) f32 intermediate, 82 GB, on an 80 GB card.
BULK_SLICES = 8
SERVE_CALLS = 100
# train_batch (65,536 rows) in 8 microbatches of 8,192: the saved CIN
# intermediates of the whole batch alone would come to about 45 GB.
TRAIN_STEPS, ACCUM_STEPS = 3, 8
GRAD_CHECK_ROWS = 512
# The gradient check's bound, |card - host| <= GRAD_ATOL + GRAD_RTOL·|host|
# element by element: sound runs read at most 3.2e-8 (PERF.md, PR 18).
GRAD_ATOL, GRAD_RTOL = 2e-7, 1e-5
# serve_bulk rows held to the host: the first and the last this many.
BULK_CHECK_ROWS = 512
RETRIEVE_CALLS, RETRIEVE_TOP = 5, 100


def to_device(torch, batch: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def host_copy(torch, tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().cpu(), tree)


def recsys_serve(torch, dev, spec, params, calls: dict) -> dict:
    """xDeepFM at serve_p99 (512 rows): 100 timed forwards after a warm-up;
    then serve_bulk (262,144 rows) in ``BULK_SLICES`` slices.  The serve
    logits, and the bulk's first and last ``BULK_CHECK_ROWS`` (of its first
    and last slice), held to the plain path on the host (params copied off
    the card) within atol = rtol = 1e-4."""
    import numpy as np
    from repro_torch.data import CTRStream
    from repro_torch.models import recsys as rec
    cfg = spec.config
    B = spec.shape("serve_p99").dim("batch")
    host = CTRStream(cfg, B, seed=SEED + 50)(0)
    host.pop("label")
    batch = to_device(torch, host, dev)
    times = []
    with torch.no_grad():
        for _ in range(SERVE_CALLS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = rec.forward(params, batch, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    calls["forwards"] += SERVE_CALLS + 1
    times = times[1:]                    # the first call warmed up

    n = spec.shape("serve_bulk").dim("batch")
    sl = n // BULK_SLICES
    bulk_host = CTRStream(cfg, n, seed=SEED + 51)(0)
    bulk_host.pop("label")
    bulk = to_device(torch, bulk_host, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = [rec.forward(params, {k: v[i * sl:(i + 1) * sl]
                                     for k, v in bulk.items()}, cfg)
                for i in range(BULK_SLICES)]
    torch.cuda.synchronize()
    bulk_s = time.perf_counter() - t0
    calls["forwards"] += BULK_SLICES
    out = torch.cat(outs)
    del outs, bulk
    check(out.shape == (n,) and bool(torch.isfinite(out).all()),
          f"xDeepFM serve_bulk: {n} finite logits in {BULK_SLICES} slices "
          f"of {sl}")

    t0 = time.perf_counter()
    cpu_params = host_copy(torch, params)
    copy_s = time.perf_counter() - t0
    k = BULK_CHECK_ROWS
    ends = {key: np.concatenate([v[:k], v[n - k:]])
            for key, v in bulk_host.items()}
    errs = {}
    for name, got, rows in (("serve_p99", logits.cpu(), host),
                            ("serve_bulk", torch.cat([out[:k], out[n - k:]]
                                                     ).cpu(), ends)):
        with torch.no_grad():
            plain = rec.forward(cpu_params, to_device(torch, rows, "cpu"),
                                cfg)
        errs[name] = float((got - plain).abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == plain.shape
              and bool(((got - plain).abs()
                        <= 1e-4 + 1e-4 * plain.abs()).all()),
              f"xDeepFM {name} logits ({got.shape[0]} rows) on the card = "
              f"the plain path on the host within atol = rtol = 1e-4 (max "
              f"diff {errs[name]:.3g})")
    del cpu_params
    err = errs["serve_p99"]
    m = {"serve_rows": B, "serve_p50_ms": statistics.median(times),
         "serve_p99_ms": pct(times, 0.99), "serve_max_ms": max(times),
         "serve_max_abs_err": err, "params_to_host_s": copy_s,
         "bulk_rows": n, "bulk_slices": BULK_SLICES, "bulk_s": bulk_s,
         "bulk_rows_per_s": n / bulk_s, "bulk_checked_rows": 2 * k,
         "bulk_max_abs_err": errs["serve_bulk"]}
    log(f"  serve_p99 ({B} rows): p50 {m['serve_p50_ms']:.3f} ms, p99 "
        f"{m['serve_p99_ms']:.3f} ms; card vs host max diff {err:.3g} "
        f"(params to host {copy_s:.2f} s); serve_bulk {n} rows in "
        f"{bulk_s * 1e3:.1f} ms ({m['bulk_rows_per_s']:.0f} rows/s; "
        f"{2 * k} rows vs host max diff {errs['serve_bulk']:.3g})")
    return m


def recsys_train(torch, dev, spec, params, calls: dict) -> tuple:
    """xDeepFM at train_batch: ``make_train_step(loss, AdamW(lr=1e-3),
    accum_steps=8)`` for ``TRAIN_STEPS`` steps on ``CTRStream(seed=0)``
    batches, from the seeded weights.  Returns (metrics, params)."""
    from repro_torch.data import CTRStream
    from repro_torch.launch.steps import recsys_model_flops
    from repro_torch.models import recsys as rec
    from repro_torch.training import AdamW, make_train_step
    cfg = spec.config
    shape = spec.shape("train_batch")
    stream = CTRStream(cfg, shape.dim("batch"), seed=0)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    step = make_train_step(lambda p, b: rec.loss(p, b, cfg), opt,
                           accum_steps=ACCUM_STEPS)
    losses, step_s, data_s = [], [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = to_device(torch, stream(i), dev)
        torch.cuda.synchronize()
        data_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        params, state, _, met = step(params, state, None, batch)
        losses.append(float(met["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        calls["microbatches"] += ACCUM_STEPS
    del state
    # Each step's loss is on its own batch; the fall is read on one batch:
    # step 0's, whose loss at the initial weights is losses[0], again after
    # the last step (a forward in the microbatches' slices).
    batch = to_device(torch, stream(0), dev)
    n = shape.dim("batch") // ACCUM_STEPS
    with torch.no_grad():
        after = sum(float(rec.loss(params, {k: v[i * n:(i + 1) * n]
                                            for k, v in batch.items()}, cfg))
                    for i in range(ACCUM_STEPS)) / ACCUM_STEPS
    calls["forwards"] += ACCUM_STEPS
    del batch
    check(all(math.isfinite(x) for x in losses + [after])
          and after < losses[0],
          f"xDeepFM training: losses finite ({[round(x, 5) for x in losses]}"
          f"), and step 0's batch's loss fell from {losses[0]:.5f} to "
          f"{after:.5f} over the {TRAIN_STEPS} steps")
    s = statistics.mean(step_s[1:])      # the first step warmed up
    flops = recsys_model_flops(cfg, shape)
    m = {"train_rows": shape.dim("batch"), "accum_steps": ACCUM_STEPS,
         "train_losses": losses, "batch0_loss_after": after,
         "train_step_s": step_s,
         "train_s_per_step": s, "train_samples_per_s": shape.dim("batch") / s,
         "train_model_flops": flops, "train_tflops": flops / s / 1e12,
         "train_fp32_peak_share": flops / s / FP32_FLOPS_PER_S,
         "train_data_s": data_s}
    log(f"  train_batch ({shape.dim('batch')} rows, {ACCUM_STEPS} "
        f"microbatches): {s:.3f} s/step (steps {[round(x, 3) for x in step_s]}"
        f"), {m['train_samples_per_s']:.0f} samples/s, "
        f"{m['train_tflops']:.2f} TFLOP/s of useful work "
        f"({100 * m['train_fp32_peak_share']:.1f}% of 67 TFLOP/s fp32); "
        f"losses {losses}")
    return m, params


# Faults planted in the bag's backward on the card, each of which the
# gradient check must see: the masked-off slots' rows added too, and the
# table gradient 0.1% too large.
PLANTED_FAULTS = ("mask dropped", "scaled by 1.001")


def planted_bag_backward(torch, sound, kind: str):
    """The sound ``_BagSum.backward`` with the fault ``kind`` on CUDA
    tensors (the host's plain path stays sound); installed and removed by
    ``recsys_grad_check``."""

    def backward(ctx, grad):
        g, a, b = sound(ctx, grad)
        if not grad.is_cuda:
            return g, a, b
        if kind == "scaled by 1.001":
            return g * 1.001, a, b
        idx, mask = ctx.saved_tensors
        bags, slots = torch.nonzero(mask == 0, as_tuple=True)
        g.index_add_(0, idx[bags, slots].long().clamp(0, g.shape[0] - 1),
                     grad[bags])
        return g, a, b
    return backward


def recsys_grad_check(torch, dev, spec, params, calls: dict) -> dict:
    """One 512-row microbatch's gradient on the card (the bag's backward
    included) against the plain path's on the host, on the same weights:
    the table rows the batch touched, ``lin_table``'s, ``dense_w`` and
    ``cin[0]``, each element within ``GRAD_ATOL + GRAD_RTOL·|host|``, and
    no gradient on a row it did not touch.  Then the same on the card with
    each of ``PLANTED_FAULTS`` in the bag's backward: the check must fail
    on each, so the bound is shown to see a dropped mask and a 0.1% scale
    error at this size."""
    import numpy as np
    from repro_torch.data import CTRStream
    from repro_torch.models import recsys as rec
    from repro_torch.models.embedding import _BagSum, field_offsets
    from repro_torch.training.train_loop import value_and_grad
    cfg = spec.config
    host = CTRStream(cfg, GRAD_CHECK_ROWS, seed=SEED + 52)(0)
    rows = np.unique(np.concatenate([
        (host["sparse_idx"] + field_offsets(cfg.field_vocab_sizes)).ravel(),
        host["multi_idx"].ravel()]))
    rows_t = torch.as_tensor(rows, dtype=torch.long)

    def loss_fn(p, b):
        return rec.loss(p, b, cfg)

    def on_card():
        loss, g = value_and_grad(loss_fn, params, to_device(torch, host,
                                                            dev))
        calls["microbatches"] += 1
        nz = torch.nonzero(g["table"].abs().sum(dim=1)).flatten().cpu()
        picked = {"table": g["table"][rows_t.to(dev)].cpu(),
                  "lin_table": g["lin_table"][rows_t.to(dev)].cpu(),
                  "dense_w": g["dense_w"].cpu(), "cin0": g["cin"][0].cpu()}
        return loss, picked, nz

    def shares(card):
        """The largest share of its bound that an element's difference
        takes, for each leaf."""
        return {k: float(((card[k] - plain[k]).abs()
                          / (GRAD_ATOL + GRAD_RTOL * plain[k].abs())).max())
                for k in card}

    l_card, card, nz = on_card()
    cpu_params = host_copy(torch, params)
    l_cpu, g_cpu = value_and_grad(loss_fn, cpu_params,
                                  to_device(torch, host, "cpu"))
    plain = {"table": g_cpu["table"][rows_t],
             "lin_table": g_cpu["lin_table"][rows_t],
             "dense_w": g_cpu["dense_w"], "cin0": g_cpu["cin"][0]}
    del cpu_params, g_cpu
    errs = {k: float((card[k] - plain[k]).abs().max()) for k in card}
    scale = {k: float(plain[k].abs().max()) for k in card}
    share = shares(card)
    check(all(x <= 1.0 for x in share.values())
          and abs(float(l_card) - float(l_cpu)) <= 1e-5,
          f"xDeepFM gradient of a {GRAD_CHECK_ROWS}-row microbatch on the "
          f"card = the plain path on the host, each element within "
          f"{GRAD_ATOL:g} + {GRAD_RTOL:g}·|host| ({len(rows)} touched rows; "
          f"max diffs {errs}; largest share of the bound {share}; max "
          f"|host| {scale}; loss {float(l_card):.6f} vs {float(l_cpu):.6f})")
    check(bool(np.isin(nz.numpy(), rows).all()),
          f"no table gradient outside the {len(rows)} touched rows "
          f"({nz.numel()} rows with one)")
    planted = {}
    sound = _BagSum.__dict__["backward"]
    try:
        for kind in PLANTED_FAULTS:
            _BagSum.backward = staticmethod(planted_bag_backward(
                torch, sound.__func__, kind))
            planted[kind] = shares(on_card()[1])
    finally:
        _BagSum.backward = sound
    check(all(p["table"] > 1.0 for p in planted.values()),
          f"the gradient check sees each planted fault in the bag's "
          f"backward on the card (largest share of the bound: {planted})")
    return {"grad_check_rows": GRAD_CHECK_ROWS, "grad_touched_rows":
            int(len(rows)), "grad_max_abs_err": errs,
            "grad_bound_share": share, "grad_host_max_abs": scale,
            "grad_planted_share": planted}


def bag_at_path_shapes(torch, table, inputs: dict, flush) -> dict:
    """``ops.embedding_bag`` as xDeepFM calls it (bool mask, no weights) at
    each of the path's shapes: bit for bit to its plain version, and cold
    times beside the plain version's, ``F.embedding_bag``'s and the bound
    (each distinct row read once, ids, mask and output once; a multiply
    and an add per slot and column)."""
    import torch.nn.functional as F
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
    dim = table.shape[1]
    out = {}
    for name, (idx, mask) in inputs.items():
        B, hot = idx.shape
        w = mask.float()
        got = embedding_bag(table, idx, mask=mask)
        plain = embedding_bag_ref(table, idx.long(), w)
        check(torch.equal(got, plain), f"embedding_bag at the path's {name} "
              f"shape ({B} x {hot}) bit-identical to the plain version")
        rows = int(torch.unique(idx).numel())
        b_ms, b_by = bound(4.0 * rows * dim + 5.0 * B * hot + 4.0 * B * dim,
                           2.0 * B * hot * dim)
        ms = cold_ms(lambda: embedding_bag(table, idx, mask=mask), 20, flush)
        plain_ms = cold_ms(lambda: embedding_bag_ref(table, idx.long(), w),
                           20, flush)
        lib_ms = cold_ms(lambda: F.embedding_bag(
            idx, table, mode="sum", per_sample_weights=w), 20, flush)
        out[name] = {"shape": [B, hot], "distinct_rows": rows, "ms": ms,
                     "plain_ms": plain_ms, "library_ms": lib_ms,
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"  embedding_bag at {name} ({B} x {hot}, {rows} distinct "
            f"rows): {ms:.4f} ms cold, plain {plain_ms:.4f} ms, "
            f"F.embedding_bag {lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return out


def recsys_launcher(torch) -> dict:
    """``launch.train.main`` in process: AutoInt at train_batch for 2 steps
    with a checkpoint, then ``--resume`` to step 3.  It starts from zeros,
    as the reference launcher does, so it checks that the entry point runs,
    checkpoints and resumes (the loss stays ln 2)."""
    import logging
    import shutil
    from repro_torch.launch import train as launcher
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.configs import get_arch
    from repro_torch.training import checkpoint
    from repro_torch.tree import leaves
    spec = get_arch("autoint")
    with one_rank_mesh("cpu") as mesh:            # shapes only
        cell = build_cell(spec, spec.shape("train_batch"), mesh)
    ckpt_bytes = sum(t.numel() * t.element_size()
                     for t in leaves(cell.args[:2]))
    del cell
    root = roomy_tmpdir("chip_smoke_train_")
    try:
        check(shutil.disk_usage(root).free > 2.2 * ckpt_bytes,
              f"room in {root} for two {ckpt_bytes / 1e9:.2f} GB "
              "checkpoints")
        args = ["--arch", "autoint", "--shape", "train_batch", "--ckpt",
                root, "--device", DEVICE]
        t0 = time.perf_counter()
        out = launcher.main(args + ["--steps", "2"])
        first_s = time.perf_counter() - t0
        hist, step = out[2], int(out[1].step)
        del out
        torch.cuda.empty_cache()
        check(len(hist) == 2 and step == 2
              and checkpoint.latest_step(root) == 2,
              f"launcher ran 2 AutoInt steps and checkpointed step 2 "
              f"({first_s:.1f} s; losses {hist})")
        t0 = time.perf_counter()
        out = launcher.main(args + ["--steps", "3", "--resume"])
        resume_s = time.perf_counter() - t0
        hist2, step2 = out[2], int(out[1].step)
        del out
        torch.cuda.empty_cache()
        check(len(hist2) == 1 and step2 == 3
              and checkpoint.latest_step(root) == 3,
              f"launcher --resume restored step 2, ran step 3 and "
              f"checkpointed it ({resume_s:.1f} s; losses {hist2})")
        check(all(abs(x - math.log(2.0)) <= 1e-6 for x in hist + hist2),
              "from zeros the AutoInt loss stays ln 2, as the reference "
              "launcher's")
    finally:
        shutil.rmtree(root, ignore_errors=True)
        logging.getLogger().setLevel(logging.WARNING)
    return {"launcher_arch": "autoint", "launcher_ckpt_gb": ckpt_bytes / 1e9,
            "launcher_first_s": first_s, "launcher_resume_s": resume_s,
            "launcher_losses": hist + hist2}


def recsys_retrieval(torch, dev) -> dict:
    """Two-tower retrieval_cand: 1 user against 1,000,000 distinct
    candidates, top 100, timed; the same candidates' rows, copied to the
    host, through the plain path there: scores within 1e-5, ids exact
    except at near-ties."""
    import numpy as np
    from repro_torch.bridge import ranked_match
    from repro_torch.configs import get_arch
    from repro_torch.models import recsys as rec
    from repro_torch.tree import leaves
    spec = get_arch("two-tower-retrieval")
    cfg = spec.config
    shape = spec.shape("retrieval_cand")
    B, C = shape.dim("batch"), shape.dim("n_candidates")
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    t0 = time.perf_counter()
    params = rec.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params_gb = sum(t.numel() * t.element_size()
                    for t in leaves(params)) / 1e9
    rng = np.random.default_rng(SEED + 54)
    fv = cfg.field_vocab_sizes
    host = {"user_id": rng.integers(0, cfg.user_vocab, B).astype(np.int32),
            "user_fields": np.stack([rng.integers(0, v, B) for v in fv[:4]],
                                    axis=1).astype(np.int32),
            "cand_ids": rng.choice(cfg.item_vocab, C,
                                   replace=False).astype(np.int32),
            "cand_fields": np.stack([rng.integers(0, v, C)
                                     for v in fv[4:6]], axis=1
                                    ).astype(np.int32)}
    batch = to_device(torch, host, dev)
    times = []
    with torch.no_grad():
        for _ in range(RETRIEVE_CALLS + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, ids = rec.retrieve(params, batch, cfg, top_k=RETRIEVE_TOP)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        times = times[1:]
        cpu_params = host_copy(torch, {
            "user_table": params["user_table"][batch["user_id"].long()],
            "item_table": params["item_table"][batch["cand_ids"].long()],
            "field_table": params["field_table"],
            "user_mlp": params["user_mlp"], "item_mlp": params["item_mlp"],
            "log_tau": params["log_tau"]})
    peak = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    cpu_batch = {"user_id": torch.arange(B, dtype=torch.int32),
                 "user_fields": torch.as_tensor(host["user_fields"]),
                 "cand_ids": torch.arange(C, dtype=torch.int32),
                 "cand_fields": torch.as_tensor(host["cand_fields"])}
    t0 = time.perf_counter()
    with torch.no_grad():
        pv, pi = rec.retrieve(cpu_params, cpu_batch, cfg, top_k=RETRIEVE_TOP)
    plain_s = time.perf_counter() - t0
    why = ranked_match(pv.numpy(), pi.numpy(), vals.cpu().numpy(),
                       ids.cpu().numpy(), 1e-5)
    exact = bool(torch.equal(pi, ids.cpu()))
    check(why is None, f"two-tower retrieval: top {RETRIEVE_TOP} of {C} "
          f"on the card = the plain path on the host (scores within 1e-5, "
          f"ids exact but for near-ties; ids identical: {exact}) ({why})")
    m = {"retrieval_candidates": C, "retrieval_top": RETRIEVE_TOP,
         "retrieval_ms": statistics.median(times), "retrieval_ms_all": times,
         "retrieval_ids_identical": exact, "retrieval_plain_s": plain_s,
         "retrieval_params_gb": params_gb, "retrieval_init_s": init_s,
         "retrieval_peak_gb": peak / 1e9}
    log(f"  retrieval_cand: {m['retrieval_ms']:.2f} ms (median of "
        f"{RETRIEVE_CALLS}; {[round(t, 2) for t in times]}), params "
        f"{params_gb:.2f} GB drawn in {init_s:.2f} s, ids identical to the "
        f"host's: {exact}; peak {peak / 1e9:.2f} GB")
    return m


def peak_gb(torch, metrics: dict) -> float:
    """The peak device memory since the last reset, in GB; resets it and
    notes what is still allocated (``metrics["allocated_gb"]``)."""
    peak = torch.cuda.max_memory_allocated() / 1e9
    metrics.setdefault("allocated_gb", []).append(
        torch.cuda.memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()
    return peak


def run_recsys(torch, dev) -> dict:
    """The recsys family and the training substrate at the registered
    configs' full widths (``repro_torch.configs``): (a) xDeepFM serving,
    (b) xDeepFM training with its gradient checked, (c) the launcher in
    process, (d) two-tower retrieval; (e) the ``embedding_bag`` launches of
    the xDeepFM half (counts zeroed before the phase, read after (b), the
    only part that runs a bag): one per forward and per training
    microbatch, exactly.  Then the kernel at the path's three shapes, held
    bit for bit to its plain version and timed."""
    from repro_torch.configs import get_arch
    from repro_torch.data import CTRStream
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import recsys as rec
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    spec = get_arch("xdeepfm")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    calls = {"forwards": 0, "microbatches": 0}
    gen = torch.Generator(device=dev).manual_seed(SEED + 49)
    t0 = time.perf_counter()
    params = rec.init_params(gen, spec.config)
    torch.cuda.synchronize()
    metrics = {"xdeepfm_init_s": time.perf_counter() - t0,
               "xdeepfm_params_gb": sum(
                   t.numel() * t.element_size()
                   for t in leaves(params)) / 1e9}
    log(f"  xDeepFM params {metrics['xdeepfm_params_gb']:.2f} GB drawn on "
        f"the card in {metrics['xdeepfm_init_s']:.2f} s")
    metrics.update(recsys_serve(torch, dev, spec, params, calls))
    serve_launches = launch_counts()["embedding_bag"]
    serve_forwards = calls["forwards"]
    metrics["serve_peak_gb"] = peak_gb(torch, metrics)
    train, params = recsys_train(torch, dev, spec, params, calls)
    metrics.update(train)
    metrics["train_peak_gb"] = peak_gb(torch, metrics)
    metrics.update(recsys_grad_check(torch, dev, spec, params, calls))
    counts = launch_counts()
    need = calls["forwards"] + calls["microbatches"]
    check(counts["embedding_bag"] == need
          and serve_launches == serve_forwards,
          f"embedding_bag launched {counts['embedding_bag']} times in the "
          f"xDeepFM half ({serve_launches} while serving): once per "
          f"forward ({calls['forwards']}, {serve_forwards} of them "
          f"serving) and per training microbatch ({calls['microbatches']})")
    metrics["embedding_bag_launches"] = counts["embedding_bag"]
    metrics["calls"] = dict(calls)

    cfg = spec.config
    serve = CTRStream(cfg, spec.shape("serve_p99").dim("batch"),
                      seed=SEED + 50)(0)
    micro = spec.shape("train_batch").dim("batch") // ACCUM_STEPS
    train0 = CTRStream(cfg, spec.shape("train_batch").dim("batch"),
                       seed=0)(0)
    n_bulk = spec.shape("serve_bulk").dim("batch")
    bulk0 = CTRStream(cfg, n_bulk, seed=SEED + 51)(0)
    inputs = {name: (torch.as_tensor(b["multi_idx"][:n], device=dev),
                     torch.as_tensor(b["multi_mask"][:n], device=dev))
              for name, b, n in (("serve_p99", serve, len(serve["label"])),
                                 ("train microbatch", train0, micro),
                                 ("serve_bulk slice", bulk0,
                                  n_bulk // BULK_SLICES))}
    del train0, bulk0
    scratch = torch.empty(L2_FLUSH_BYTES // 4, device=dev)
    metrics["bag_path"] = bag_at_path_shapes(torch, params["table"], inputs,
                                             scratch.zero_)
    log("  an xDeepFM serve_p99 forward under the profiler:")
    batch = to_device(torch, {k: v for k, v in serve.items()
                              if k != "label"}, dev)
    with torch.no_grad():
        metrics["serve_profile"] = device_share(
            torch, lambda: rec.forward(params, batch, cfg), 5)
    del batch
    metrics["grad_check_peak_gb"] = peak_gb(torch, metrics)
    metrics["xdeepfm_peak_gb"] = max(metrics[k] for k in (
        "serve_peak_gb", "train_peak_gb", "grad_check_peak_gb"))
    del params, scratch, inputs
    torch.cuda.empty_cache()

    peak_gb(torch, metrics)
    metrics.update(recsys_launcher(torch))
    metrics["launcher_peak_gb"] = peak_gb(torch, metrics)
    torch.cuda.empty_cache()
    metrics.update(recsys_retrieval(torch, dev))
    peak_gb(torch, metrics)
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  embedding_bag launches {counts['embedding_bag']} "
        f"({calls}); peaks: serve {metrics['serve_peak_gb']:.2f} GB, train "
        f"{metrics['train_peak_gb']:.2f} GB, gradient check "
        f"{metrics['grad_check_peak_gb']:.2f} GB, launcher "
        f"{metrics['launcher_peak_gb']:.2f} GB, retrieval "
        f"{metrics['retrieval_peak_gb']:.2f} GB (still allocated after "
        f"each: {[round(x, 2) for x in metrics['allocated_gb']]} GB); "
        f"phase {metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# Phase 11: the LM family
# ---------------------------------------------------------------------------

# (a) gemma3-1b serving: 16 prompts of 2,048 tokens (8 distinct, each
# twice), 32 new tokens, the global cache grown to 4,096.  (b) card
# against host: 2 prompts cut to 256 tokens and 4 decode steps.  (c) the
# reference's cells: prefill_32k with its batch cut from 32 to 1,
# decode_32k and long_500k at their full shapes (8 steps each), train_4k
# with its batch cut from 256 to LM_TRAIN_BATCH (2 steps).  (d)
# OLMoE-1B-7B serving 8 prompts of 1,024 tokens (4 distinct), 16 new
# tokens; its host check cut to the first 2 layers at full width (1 prompt
# of 128 tokens, 2 decode steps).
LM_SERVE = dict(n_prompts=16, n_distinct=8, prompt_len=2048, n_new=32,
                max_len=4096)
MOE_SERVE = dict(n_prompts=8, n_distinct=4, prompt_len=1024, n_new=16,
                 max_len=1024 + 16)
LM_HOST = dict(rows=2, prompt_len=256, steps=4)
MOE_HOST = dict(rows=1, prompt_len=128, steps=2)
MOE_HOST_LAYERS = 2
LM_CELL_STEPS = 8
LM_PREFILL_BATCH = 1
LM_TRAIN_BATCH, LM_TRAIN_STEPS = 8, 2
LM_TRAIN_BUDGET_GB = 60.0
GEMMA3_1B_PARAMS = 999_812_736
# Logits of the card against the host in bfloat16 (the bound PERF.md
# section 6 states): the RMS of the difference within 1/16 of the host's
# RMS; a greedy token may differ only where the host's top two logits lie
# within twice the row's largest difference.
LM_LOGIT_RMS_FRAC = 1 / 16


def tree_bytes(tree) -> int:
    from repro_torch.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def read_bound_ms(params, cache) -> float:
    """The least time of a decode step: every weight and the whole cache
    read once at the memory rate (the MoE's capacity buffer spans every
    expert, so its step reads them all)."""
    return (tree_bytes(params) + tree_bytes(cache)) / HBM_BYTES_PER_S * 1e3


class TimedCalls:
    """A callable that records a CUDA event pair around each call of
    ``fn`` and keeps the last call's arguments."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.spans, self.last_args = torch, fn, [], None

    def __call__(self, *args):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.spans.append((start, end))
        self.last_args = args
        return out

    def ms(self) -> list[float]:
        """Milliseconds of each call (after a synchronize)."""
        return [s.elapsed_time(e) for s, e in self.spans]


def lm_serve(torch, cfg, params, label: str, n_prompts: int,
             n_distinct: int, prompt_len: int, n_new: int,
             max_len: int) -> dict:
    """``LMServer.generate`` with and without dedup on ``n_prompts``
    prompts from ``TokenPipeline(seed=0)``, ``n_distinct`` of them
    distinct, each repeated: the completions must be equal, the prefill
    rows and savings the plan's.  The dedup run's prefill and decode steps
    timed by CUDA events, its wall time, and the device share of one
    decode step under the profiler."""
    import numpy as np
    from repro_torch.data import TokenPipeline
    from repro_torch.serving import LMServer
    distinct = TokenPipeline(cfg.vocab_size, n_distinct, prompt_len,
                             seed=0)(0)["tokens"]
    batch = distinct[np.arange(n_prompts) % n_distinct]
    srv = LMServer(params, cfg, max_len=max_len)
    srv.generate(batch[:1, :64], n_new=2)          # first-call effects
    srv._prefill = TimedCalls(torch, srv._prefill)
    srv._decode = TimedCalls(torch, srv._decode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, info = srv.generate(batch, n_new=n_new, dedup=True)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    prefill_ms, decode_ms = srv._prefill.ms()[0], srv._decode.ms()
    decode = srv._decode
    out_full, info_full = srv.generate(batch, n_new=n_new, dedup=False)
    check(np.array_equal(out, out_full),
          f"{label}: completions with and without dedup equal "
          f"({out.shape[0]} x {out.shape[1]})")
    check(info["prefill_rows"] == n_distinct
          and info_full["prefill_rows"] == n_prompts
          and info["dedup_savings"] == 1 - n_distinct / n_prompts,
          f"{label}: prefill rows {info['prefill_rows']} and "
          f"{info_full['prefill_rows']}, dedup savings "
          f"{info['dedup_savings']}")
    check(all(np.array_equal(out[i], out[i % n_distinct])
              for i in range(n_prompts)),
          f"{label}: every repeat has its twin's completion")
    bound = read_bound_ms(decode.last_args[0], decode.last_args[1])
    log(f"  {label}: one decode step (batch {n_distinct}; read bound "
        f"{bound:.3f} ms) under the profiler:")
    with torch.no_grad():
        share = device_share(torch, lambda: decode.fn(*decode.last_args), 5)
    m = {"prompts": n_prompts, "distinct": n_distinct,
         "prompt_len": prompt_len, "n_new": n_new,
         "prefill_tokens": n_distinct * prompt_len, "prefill_ms": prefill_ms,
         "decode_ms_p50": pct(decode_ms, 0.5),
         "decode_ms_p99": pct(decode_ms, 0.99), "decode_steps": len(decode_ms),
         "decode_read_bound_ms": bound, "generate_s": wall_s,
         "completion_tokens_per_s": n_prompts * n_new / wall_s,
         "peak_gb": peak, "decode_profile": share}
    log(f"  {label}: prefill {prefill_ms:.1f} ms for {m['prefill_tokens']} "
        f"tokens; decode p50 {m['decode_ms_p50']:.2f} ms, p99 "
        f"{m['decode_ms_p99']:.2f} ms a step ({len(decode_ms)} steps); "
        f"generate {wall_s:.2f} s, {m['completion_tokens_per_s']:.0f} "
        f"completion tokens/s; peak {peak:.2f} GB")
    return m


def logits_agree(torch, card, host) -> dict:
    """The card's logits against the host's (bfloat16 models): the RMS of
    the difference against the host's RMS, and which greedy tokens are
    equal or excused, i.e. where the host's top two logits of a row lie
    within twice that row's largest difference."""
    card, host = card.float().cpu(), host.float()
    diff = (card - host).abs()
    top2 = torch.topk(host, 2, dim=-1).values
    same = card.argmax(-1) == host.argmax(-1)
    excused = ~same & (top2[:, 0] - top2[:, 1] <= 2 * diff.max(-1).values)
    return {"finite": bool(torch.isfinite(card).all()),
            "rms_diff": float((card - host).square().mean().sqrt()),
            "rms_host": float(host.square().mean().sqrt()),
            "max_diff": float(diff.max()), "tokens_equal": int(same.sum()),
            "tokens": int(same.numel()),
            "near_ties_excused": int(excused.sum())}


def prefill_then_decode(torch, cfg, params, tokens, steps: int,
                        feed: list) -> list:
    """The logits of ``prefill`` and of ``steps`` decode steps, the global
    cache grown by ``steps``; step i is fed ``feed[i]``, or, where ``feed``
    is short, the greedy token, which it then appends to ``feed``."""
    from repro_torch.models import transformer as lm
    S = tokens.shape[1]
    dev = params["embed"].device
    with torch.no_grad():
        logits, cache = lm.prefill(params, tokens.to(dev), cfg)
        for k in ("kg", "vg"):
            c = cache[k]
            grown = c.new_zeros((*c.shape[:2], S + steps, *c.shape[3:]))
            grown[:, :, :S] = c
            cache[k] = grown
        out = [logits]
        for i in range(steps):
            if len(feed) == i:
                feed.append(torch.argmax(logits, -1)[:, None].to(
                    torch.int32).cpu())
            logits, cache = lm.decode_step(params, cache, feed[i].to(dev),
                                           S + i, cfg)
            out.append(logits)
    return out


def lm_card_vs_host(torch, dev, cfg, params, label: str, rows: int,
                    prompt_len: int, steps: int) -> dict:
    """``prefill`` and ``steps`` decode steps on the host's plain path
    with the card's weights copied over, then on the card, each step fed
    the host's greedy token; every row of logits held to
    ``logits_agree``."""
    from repro_torch.data import TokenPipeline
    from repro_torch.tree import tree_map
    tokens = torch.as_tensor(TokenPipeline(cfg.vocab_size, rows, prompt_len,
                                           seed=1)(0)["tokens"])
    t0 = time.perf_counter()
    host_params = tree_map(lambda t: t.cpu(), params)
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feed: list = []
    host = prefill_then_decode(torch, cfg, host_params, tokens, steps, feed)
    host_s = time.perf_counter() - t0
    del host_params
    card = prefill_then_decode(torch, cfg, params, tokens, steps, feed)
    per_step = [logits_agree(torch, c, h) for c, h in zip(card, host)]
    m = {"rows": rows, "prompt_len": prompt_len, "decode_steps": steps,
         "rms_ratio_max": max(s["rms_diff"] / s["rms_host"]
                              for s in per_step),
         "rms_diff_max": max(s["rms_diff"] for s in per_step),
         "max_diff": max(s["max_diff"] for s in per_step),
         "tokens_equal": sum(s["tokens_equal"] for s in per_step),
         "tokens": sum(s["tokens"] for s in per_step),
         "near_ties_excused": sum(s["near_ties_excused"] for s in per_step),
         "host_copy_s": copy_s, "host_s": host_s}
    check(all(s["finite"] for s in per_step)
          and m["rms_ratio_max"] <= LM_LOGIT_RMS_FRAC
          and m["tokens_equal"] + m["near_ties_excused"] == m["tokens"],
          f"{label}: card logits = host logits (bf16) at the prefill and "
          f"{steps} decode steps: RMS difference at most "
          f"{m['rms_ratio_max']:.3g} of the host's RMS (bound "
          f"{LM_LOGIT_RMS_FRAC:.4g}), largest difference "
          f"{m['max_diff']:.3g}; greedy tokens equal "
          f"{m['tokens_equal']}/{m['tokens']} "
          f"({m['near_ties_excused']} near-ties excused); host run "
          f"{host_s:.1f} s")
    return m


def lm_cells(torch, dev, spec, params, mesh) -> dict:
    """The reference's four cells of ``spec`` through
    ``steps.build_cell``, each run: prefill_32k (batch cut to
    ``LM_PREFILL_BATCH``), decode_32k and long_500k at full shape
    (``LM_CELL_STEPS`` steps each, the cache random, its ring holding the
    positions a prefill would leave), train_4k (batch cut to
    ``LM_TRAIN_BATCH``, ``LM_TRAIN_STEPS`` steps from the given weights)."""
    import numpy as np
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.training.optimizer import AdamW
    cfg = spec.config
    out = {}

    # prefill_32k
    full = spec.shape("prefill_32k")
    S = full.dim("seq_len")
    shape = ShapeSpec(full.name, full.kind, {**full.dims,
                                             "global_batch":
                                             LM_PREFILL_BATCH})
    cell = build_cell(spec, shape, mesh)
    tokens = torch.as_tensor(TokenPipeline(cfg.vocab_size, LM_PREFILL_BATCH,
                                           S, seed=2)(0)["tokens"],
                             device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, cache = cell.fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    W = cfg.window
    ring_ok = bool(torch.equal(
        torch.sort(cache["ring_pos"]).values.cpu(),
        torch.arange(S - W, S, dtype=torch.int32)))
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (LM_PREFILL_BATCH, cfg.vocab_size) and ring_ok
          and cache["kg"].shape[2] == S,
          f"prefill_32k (batch {LM_PREFILL_BATCH} of "
          f"{full.dim('global_batch')}, S = {S}: {S // 2048} KV chunks): "
          f"finite logits, the ring holds positions {S - W}..{S - 1}, the "
          f"global cache {S} long")
    # The weights' products (lm_model_flops) and the scores and
    # probability-value products over every key of every layer, as the
    # reference computes them, at the bf16 rate.
    flops = cell.model_flops + 4.0 * LM_PREFILL_BATCH * cfg.n_heads * \
        S * S * cfg.head_dim * cfg.n_layers
    out["prefill_32k"] = {"batch": LM_PREFILL_BATCH, "seq_len": S,
                          "ms": ms, "tokens_per_s": LM_PREFILL_BATCH * S /
                          ms * 1e3, "model_flops": cell.model_flops,
                          "flops": flops,
                          "bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
                          "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"  prefill_32k: {ms:.0f} ms (bound "
        f"{out['prefill_32k']['bound_ms']:.0f} ms: {flops:.3g} FLOP at the "
        "bf16 rate), "
        f"{out['prefill_32k']['tokens_per_s']:.0f} tokens/s, peak "
        f"{out['prefill_32k']['peak_gb']:.2f} GB")
    del logits, cache, tokens
    torch.cuda.empty_cache()

    # decode_32k and long_500k
    for name in ("decode_32k", "long_500k"):
        shape = spec.shape(name)
        B, S = shape.dim("global_batch"), shape.dim("seq_len")
        cell = build_cell(spec, shape, mesh)
        _p, cache_s, _t, _pos = cell.args
        start = S - LM_CELL_STEPS
        cache = {}
        for k, s in cache_s.items():
            if k == "ring_pos":
                p = torch.arange(start - W, start, dtype=torch.int32,
                                 device=dev)
                cache[k] = torch.empty(W, dtype=torch.int32, device=dev)
                cache[k][p % W] = p
            else:
                cache[k] = torch.randn(s.shape, dtype=s.dtype, device=dev)
        cache_gb = sum(t.numel() * t.element_size()
                       for t in cache.values()) / 1e9
        tok = torch.as_tensor(np.random.default_rng(SEED + 60).integers(
            0, cfg.vocab_size, (B, 1)).astype(np.int32), device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        steps_ms = []
        with torch.no_grad():
            for i in range(LM_CELL_STEPS):
                t0 = time.perf_counter()
                logits, cache = cell.fn(params, cache, tok, start + i)
                tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
                torch.cuda.synchronize()
                steps_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(logits).all())
              and logits.shape == (B, cfg.vocab_size)
              and int(cache["ring_pos"][(S - 1) % W]) == S - 1,
              f"{name} (B = {B}, cache {S}, {cache_gb:.1f} GB): "
              f"{LM_CELL_STEPS} steps, finite logits, the ring holds the "
              f"last position")
        out[name] = {"batch": B, "seq_len": S, "cache_gb": cache_gb,
                     "step_ms": steps_ms,
                     "step_ms_p50": pct(steps_ms[1:], 0.5),
                     "read_bound_ms": read_bound_ms(params, cache),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  {name}: step p50 {out[name]['step_ms_p50']:.2f} ms (first "
            f"{steps_ms[0]:.2f} ms; read bound "
            f"{out[name]['read_bound_ms']:.3f} ms), cache {cache_gb:.2f} GB, "
            "peak "
            f"{out[name]['peak_gb']:.2f} GB; the last step again under the "
            "profiler:")
        with torch.no_grad():
            out[name]["profile"] = device_share(
                torch, lambda: cell.fn(params, cache, tok, S - 1), 3)
        del cache, logits, tok
        torch.cuda.empty_cache()

    # train_4k
    full = spec.shape("train_4k")
    S = full.dim("seq_len")
    shape = ShapeSpec(full.name, full.kind, {**full.dims,
                                             "global_batch": LM_TRAIN_BATCH})
    cell = build_cell(spec, shape, mesh)
    pipe = TokenPipeline(cfg.vocab_size, LM_TRAIN_BATCH, S, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p = params
    opt_state = AdamW(lr=3e-4, weight_decay=0.01).init(p)
    losses, steps_s = [], []
    for i in range(LM_TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(pipe(i)["tokens"], device=dev)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, opt_state, loss = cell.fn(p, opt_state, batch)
        losses.append(float(loss))
        steps_s.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses) and peak <=
          LM_TRAIN_BUDGET_GB,
          f"train_4k (batch {LM_TRAIN_BATCH} of {full.dim('global_batch')}, "
          f"S = {S}, remat, AdamW): {LM_TRAIN_STEPS} steps, finite losses "
          f"{[round(x, 4) for x in losses]}, peak {peak:.2f} GB within "
          f"{LM_TRAIN_BUDGET_GB:.0f}")
    s_step = steps_s[-1]
    out["train_4k"] = {"batch": LM_TRAIN_BATCH, "seq_len": S,
                       "losses": losses, "step_s": steps_s,
                       "tokens_per_s": LM_TRAIN_BATCH * S / s_step,
                       "model_tflops_per_s": cell.model_flops / s_step / 1e12,
                       "bf16_peak_share": cell.model_flops / s_step /
                       BF16_FLOPS_PER_S, "peak_gb": peak}
    log(f"  train_4k: {s_step:.3f} s a step (first {steps_s[0]:.3f} s), "
        f"{out['train_4k']['tokens_per_s']:.0f} tokens/s, "
        f"{out['train_4k']['model_tflops_per_s']:.1f} TFLOP/s of "
        f"lm_model_flops ({out['train_4k']['bf16_peak_share']:.1%} of the "
        f"989 TFLOP/s bf16 peak), peak {peak:.2f} GB")
    del p, opt_state, batch, loss
    torch.cuda.empty_cache()
    return out


def run_lm(torch, dev) -> dict:
    """The LM family at full width (``repro_torch.configs``): (a) gemma3-1b
    served by ``LMServer``, (b) its logits on the card against the host,
    (c) its four reference cells through ``steps.build_cell``, (d)
    OLMoE-1B-7B served and held to the host on its first two layers.
    Launch counts zeroed at the start and read at the end: the LM path
    launches none of the seven kernels."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.models import transformer as lm
    from repro_torch.tree import leaves
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    metrics = {}

    spec = get_arch("gemma3-1b")
    cfg = spec.config
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    check(n == cfg.param_count() == GEMMA3_1B_PARAMS,
          f"gemma3-1b at full width: {n:,} params drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab_size:,}, bf16)")
    metrics["gemma3_serve"] = lm_serve(torch, cfg, params,
                                       "gemma3-1b serve", **LM_SERVE)
    metrics["gemma3_card_vs_host"] = lm_card_vs_host(
        torch, dev, cfg, params, "gemma3-1b", **LM_HOST)
    with one_rank_mesh() as mesh:
        metrics["gemma3_cells"] = lm_cells(torch, dev, spec, params, mesh)
    del params
    torch.cuda.empty_cache()

    spec = get_arch("olmoe-1b-7b")
    cfg = spec.config
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(dev).manual_seed(SEED), cfg)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in leaves(params))
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    check(n == cfg.param_count(),
          f"OLMoE-1B-7B at full width: {n:,} params "
          f"({n * 2 / 1e9:.2f} GB bf16) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s (peak {init_peak:.2f} GB)")
    metrics["olmoe_serve"] = lm_serve(torch, cfg, params, "olmoe serve",
                                      **MOE_SERVE)
    cut = dataclasses.replace(cfg, n_layers=MOE_HOST_LAYERS)
    cut_params = {**params, "layers": {k: v[:MOE_HOST_LAYERS] for k, v in
                                       params["layers"].items()}}
    metrics["olmoe_card_vs_host"] = lm_card_vs_host(
        torch, dev, cut, cut_params,
        f"olmoe (first {MOE_HOST_LAYERS} of {cfg.n_layers} layers)",
        **MOE_HOST)
    metrics["olmoe_card_vs_host"]["layers"] = MOE_HOST_LAYERS
    del params, cut_params
    torch.cuda.empty_cache()

    counts = launch_counts()
    check(not any(counts.values()),
          f"the LM path launched none of the seven kernels ({counts}); the "
          "kernels line does not count this phase")
    metrics["kernel_launches"] = counts
    metrics["cuts"] = {
        "prefill_32k": f"batch {LM_PREFILL_BATCH} of 32",
        "train_4k": f"batch {LM_TRAIN_BATCH} of 256",
        "olmoe_card_vs_host": f"first {MOE_HOST_LAYERS} of 16 layers",
        "gemma3_card_vs_host": f"{LM_HOST['rows']} prompts cut to "
                               f"{LM_HOST['prompt_len']} tokens"}
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase {metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# Phase 11b: OLMoE through expert parallelism (models.moe_ep)
# ---------------------------------------------------------------------------

MOE_EP_PREFILL_BATCH = 1                  # of prefill_32k's 32
# train_4k cut from 16 layers to 4 (16 bytes a param: bf16 params and
# gradients, fp32 master and two moments; 16 layers would take 110.7 GB)
# and from batch 256 to 8 (32,768 tokens).
MOE_EP_TRAIN_LAYERS, MOE_EP_TRAIN_BATCH, MOE_EP_TRAIN_STEPS = 4, 8, 2
MOE_EP_TRAIN_BUDGET_GB = 70.0
# moe_ffn_ep against moe_ffn on one full-width layer in bf16 at 4,096
# tokens and capacity factor E/k, where no choice drops in either: both
# compute the same per-token expert products (the bound PERF.md section 6
# states): the output's and each gradient's RMS difference within 1/64 of
# the plain path's RMS, the aux loss within 1e-5 relative.
MOE_EP_CHECK_TOKENS = 4096
MOE_EP_RMS_FRAC = 1 / 64


def rms_ratio(torch, got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    den = float(want.square().mean().sqrt())
    return float((got - want).square().mean().sqrt()) / max(den, 1e-30)


def moe_ep_vs_plain(torch, dev, cfg, info) -> dict:
    """One full-width OLMoE layer's MoE at ``MOE_EP_CHECK_TOKENS`` tokens:
    ``moe_ffn_ep`` on the (1, 1) mesh against ``moe_ffn`` (one group), the
    output, the aux loss and the gradients of x, router, w_in and w_out;
    and each path's forward timed."""
    import dataclasses
    from repro_torch.models import transformer as lm
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep
    m = cfg.moe
    mcfg = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    one = dataclasses.replace(cfg, n_layers=1)
    gen = torch.Generator(dev).manual_seed(SEED + 70)
    lp = {k: v[0] for k, v in lm.init_params(gen, one)["layers"].items()}
    x = torch.randn((1, MOE_EP_CHECK_TOKENS, cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    ct = torch.randn(x.shape, generator=gen, device=dev)
    ins = (x, lp["router"], lp["w_in_e"], lp["w_out_e"])
    paths = {
        "moe_ffn": lambda *a: moe_ffn(*a[:4], None, mcfg, cfg.act,
                                      group_size=MOE_EP_CHECK_TOKENS),
        "moe_ffn_ep": lambda *a: moe_ffn_ep(*a, mcfg, cfg.act, info)}
    res, ms = {}, {}
    for name, fn in paths.items():
        leaves_ = [t.detach().clone().requires_grad_() for t in ins]
        y, aux = fn(*leaves_)
        grads = torch.autograd.grad((y.float() * ct).sum() + aux, leaves_)
        res[name] = (y.detach(), float(aux.detach()), grads)
        del y, grads, leaves_
        with torch.no_grad():
            ms[name] = cuda_ms(lambda: fn(*ins), reps=5)
    (wy, waux, wg), (y, aux, g) = res["moe_ffn"], res["moe_ffn_ep"]
    out = {"tokens": MOE_EP_CHECK_TOKENS,
           "capacity_factor": mcfg.capacity_factor,
           "out_rms_ratio": rms_ratio(torch, y, wy),
           "out_max_diff": float((y.float() - wy.float()).abs().max()),
           "aux": aux, "aux_plain": waux,
           "aux_rel_err": abs(aux - waux) / abs(waux),
           "grad_rms_ratio": {k: rms_ratio(torch, a, b) for k, a, b in
                              zip(("x", "router", "w_in", "w_out"), g, wg)},
           "fwd_ms": ms["moe_ffn_ep"], "plain_fwd_ms": ms["moe_ffn"]}
    check(out["out_rms_ratio"] <= MOE_EP_RMS_FRAC
          and out["aux_rel_err"] <= 1e-5
          and max(out["grad_rms_ratio"].values()) <= MOE_EP_RMS_FRAC,
          f"moe_ffn_ep = moe_ffn on one full-width layer (bf16, "
          f"{MOE_EP_CHECK_TOKENS} tokens, capacity factor "
          f"{mcfg.capacity_factor:g}: nothing drops): output RMS diff "
          f"{out['out_rms_ratio']:.3g} of its RMS (largest diff "
          f"{out['out_max_diff']:.3g}), aux rel err "
          f"{out['aux_rel_err']:.3g}, gradients' RMS diffs "
          f"{ {k: round(v, 6) for k, v in out['grad_rms_ratio'].items()} } "
          f"(bounds {MOE_EP_RMS_FRAC:.4g}, 1e-5); forward "
          f"{ms['moe_ffn_ep']:.2f} ms against {ms['moe_ffn']:.2f} ms")
    return out


def moe_ep_prefill(torch, dev, spec, mesh, calls: list) -> dict:
    """prefill_32k at full depth, batch ``MOE_EP_PREFILL_BATCH``, through
    ``build_cell`` on the (1, 1) mesh: timed by CUDA events, then once
    under the profiler."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as lm
    cfg = spec.config
    full = spec.shape("prefill_32k")
    S = full.dim("seq_len")
    shape = ShapeSpec(full.name, full.kind,
                      {**full.dims, "global_batch": MOE_EP_PREFILL_BATCH})
    cell = build_cell(spec, shape, mesh)
    params = lm.init_params(torch.Generator(dev).manual_seed(SEED), cfg)
    batch = {"tokens": torch.as_tensor(TokenPipeline(
        cfg.vocab_size, MOE_EP_PREFILL_BATCH, S, seed=2)(0)["tokens"],
        device=dev)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = torch.cuda.Event
    start, end = ev(enable_timing=True), ev(enable_timing=True)
    calls[0] = 0
    start.record()
    with torch.no_grad():
        logits, cache = cell.fn(params, batch)
    end.record()
    torch.cuda.synchronize()
    ms, n_calls = start.elapsed_time(end), calls[0]
    peak = torch.cuda.max_memory_allocated() / 1e9
    T = MOE_EP_PREFILL_BATCH * S
    C = max(8, -(-int(T * cfg.moe.top_k * cfg.moe.capacity_factor /
                      cfg.moe.n_experts) // 8) * 8)
    check(bool(torch.isfinite(logits).all())
          and logits.shape == (MOE_EP_PREFILL_BATCH, cfg.vocab_size)
          and cache["kg"].shape[2] == S and n_calls == cfg.n_layers,
          f"OLMoE prefill_32k through moe_ffn_ep ({cfg.n_layers} layers, "
          f"batch {MOE_EP_PREFILL_BATCH} of {full.dim('global_batch')}, "
          f"{T} tokens, capacity {C} a expert): finite logits, the cache "
          f"{S} long, {n_calls} moe_ffn_ep calls")
    flops = cell.model_flops + 4.0 * MOE_EP_PREFILL_BATCH * cfg.n_heads * \
        S * S * cfg.head_dim * cfg.n_layers
    out = {"layers": cfg.n_layers, "batch": MOE_EP_PREFILL_BATCH,
           "seq_len": S, "tokens": T, "capacity": C,
           "dispatch_gb_a_layer": cfg.moe.n_experts * C * cfg.d_model * 2
           / 1e9, "ms": ms, "tokens_per_s": T / ms * 1e3,
           "moe_ffn_ep_calls": n_calls, "model_flops": cell.model_flops,
           "flops": flops, "bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
           "peak_gb": peak}
    log(f"  prefill_32k: {ms:.0f} ms (bound {out['bound_ms']:.0f} ms), "
        f"{out['tokens_per_s']:.0f} tokens/s, {n_calls} moe_ffn_ep calls, "
        f"peak {peak:.2f} GB; again under the profiler:")
    del logits, cache
    with torch.no_grad():
        out["profile"] = device_share(torch, lambda: cell.fn(params, batch),
                                      reps=1)
    del params, batch
    torch.cuda.empty_cache()
    return out


def moe_ep_train(torch, dev, spec, mesh, calls: list) -> dict:
    """train_4k cut to ``MOE_EP_TRAIN_LAYERS`` layers and batch
    ``MOE_EP_TRAIN_BATCH``: ``MOE_EP_TRAIN_STEPS`` AdamW steps through
    ``build_cell`` on the (1, 1) mesh from seeded weights, each timed by
    CUDA events, then one more under the profiler."""
    import dataclasses
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import transformer as lm
    from repro_torch.training.optimizer import AdamW
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(spec.config, n_layers=MOE_EP_TRAIN_LAYERS)
    spec = dataclasses.replace(spec, config=cfg)
    full = spec.shape("train_4k")
    S = full.dim("seq_len")
    shape = ShapeSpec(full.name, full.kind,
                      {**full.dims, "global_batch": MOE_EP_TRAIN_BATCH})
    cell = build_cell(spec, shape, mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(torch.Generator(dev).manual_seed(SEED), cfg)
    n_params = sum(t.numel() for t in leaves(params))
    opt_state = AdamW(lr=3e-4, weight_decay=0.01).init(params)
    pipe = TokenPipeline(cfg.vocab_size, MOE_EP_TRAIN_BATCH, S, seed=0)
    state = [params, opt_state]
    del params, opt_state

    def step(batch):
        state[0], state[1], loss = cell.fn(state[0], state[1], batch)
        return loss

    ev = torch.cuda.Event
    losses, steps_ms, n_calls = [], [], []
    for i in range(MOE_EP_TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(pipe(i)["tokens"], device=dev)}
        torch.cuda.synchronize()
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        calls[0] = 0
        start.record()
        loss = step(batch)
        end.record()
        torch.cuda.synchronize()
        losses.append(float(loss))
        steps_ms.append(start.elapsed_time(end))
        n_calls.append(calls[0])
    peak = torch.cuda.max_memory_allocated() / 1e9
    want_calls = cfg.n_layers * (2 if cfg.remat else 1)
    check(all(math.isfinite(x) for x in losses) and peak <=
          MOE_EP_TRAIN_BUDGET_GB and all(c == want_calls for c in n_calls),
          f"OLMoE train_4k through moe_ffn_ep ({cfg.n_layers} of 16 layers, "
          f"{n_params:,} params, batch {MOE_EP_TRAIN_BATCH} of "
          f"{full.dim('global_batch')}, S = {S}, remat, AdamW): "
          f"{MOE_EP_TRAIN_STEPS} steps, finite losses "
          f"{[round(x, 4) for x in losses]}, moe_ffn_ep calls a step "
          f"{n_calls} (forward and the remat recompute: {want_calls}), "
          f"peak {peak:.2f} GB within {MOE_EP_TRAIN_BUDGET_GB:.0f}")
    s_step = steps_ms[-1] / 1e3
    tokens = MOE_EP_TRAIN_BATCH * S
    out = {"layers": cfg.n_layers, "params": n_params,
           "batch": MOE_EP_TRAIN_BATCH, "seq_len": S, "tokens": tokens,
           "losses": losses, "step_ms": steps_ms,
           "moe_ffn_ep_calls": n_calls, "tokens_per_s": tokens / s_step,
           "model_flops": cell.model_flops,
           "model_tflops_per_s": cell.model_flops / s_step / 1e12,
           "bf16_peak_share": cell.model_flops / s_step / BF16_FLOPS_PER_S,
           "peak_gb": peak}
    log(f"  train_4k ({cfg.n_layers} layers): {s_step:.3f} s a step (first "
        f"{steps_ms[0] / 1e3:.3f} s), {out['tokens_per_s']:.0f} tokens/s, "
        f"{out['model_tflops_per_s']:.1f} TFLOP/s of lm_model_flops "
        f"({out['bf16_peak_share']:.1%} of the 989 TFLOP/s bf16 peak), "
        f"peak {peak:.2f} GB; one more step under the profiler:")
    out["profile"] = device_share(torch, lambda: step(batch), reps=1)
    del state[:], batch, loss
    torch.cuda.empty_cache()
    return out


def run_moe_ep(torch, dev) -> dict:
    """OLMoE-1B-7B's train and prefill cells on a (1, 1) mesh over a
    one-rank NCCL group, where the reference's rule (experts divide the
    model axis, a train or prefill kind) routes every MoE layer through
    ``models.moe_ep``: the hooks checked, ``moe_ffn_ep`` held to ``moe_ffn``
    on one layer, then prefill_32k and train_4k, each ``moe_ffn_ep`` call
    counted.  Launch counts zeroed at the start and read at the end: the
    path launches none of the seven kernels."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import one_rank_mesh
    from repro_torch.models import transformer as lm
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launch_counts()
    spec = get_arch("olmoe-1b-7b")
    cfg = spec.config
    calls = [0]
    real = lm.moe_ffn_ep

    def counted(*args):
        calls[0] += 1
        return real(*args)

    metrics = {}
    lm.moe_ffn_ep = counted
    try:
        with one_rank_mesh() as mesh:
            ax = shd.mesh_axes(mesh)
            infos = {kind: shd.lm_shardings(cfg, ax, kind, 1, 4096)[
                "hooks"].moe_ep for kind in ("train", "prefill", "decode")}
            check(infos["train"] is not None and infos["prefill"] is not None
                  and infos["decode"] is None,
                  f"OLMoE on the (1, 1) mesh: hooks.moe_ep set for train "
                  f"and prefill ({infos['train']}), not for decode")
            info = infos["train"]._replace(mesh=mesh)
            metrics["moe_ep_vs_moe_ffn"] = moe_ep_vs_plain(torch, dev, cfg,
                                                          info)
            metrics["prefill_32k"] = moe_ep_prefill(torch, dev, spec, mesh,
                                                    calls)
            metrics["train_4k"] = moe_ep_train(torch, dev, spec, mesh, calls)
    finally:
        lm.moe_ffn_ep = real
    counts = launch_counts()
    check(not any(counts.values()),
          f"the MoE-EP path launched none of the seven kernels ({counts}); "
          "the kernels line does not count this phase")
    metrics["kernel_launches"] = counts
    metrics["cuts"] = {
        "prefill_32k": f"batch {MOE_EP_PREFILL_BATCH} of 32",
        "train_4k": f"{MOE_EP_TRAIN_LAYERS} of 16 layers, batch "
                    f"{MOE_EP_TRAIN_BATCH} of 256"}
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase {metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# Phase 12: the GNN family
# ---------------------------------------------------------------------------

# Each cell: one warm-up AdamW step and GNN_STEPS timed ones, all on one
# batch, so step 0's loss must fall.  Card against host (the bounds PERF.md
# section 6 states): the loss within GNN_LOSS_RTOL relative, each gradient
# leaf within GNN_GRAD_RTOL of its largest |host value| (index_add_ adds
# with atomics in no fixed order on the card).
GNN_STEPS = 3
GNN_LOSS_RTOL, GNN_GRAD_RTOL = 1e-5, 1e-4
# ogb_products is too large for the host: there the chunked edge-parallel
# loss is held to the unchunked plain loss on the card, on the graph's
# first 2**22 edges plus its self-loops.
GNN_OGB_CHECK_EDGES = 1 << 22
# ogbn-products' public split trains on 196,615 of its 2,449,029 nodes.
OGB_TRAIN_NODES = 196_615
GNN_LEAVES = [(layer, k) for layer in ("l1", "l2")
              for k in ("W", "a_src", "a_dst")]


def pad_graph(g: dict, n_pad: int, e_pad: int) -> dict:
    """A graph padded as ``gnn.input_structs`` states: ``n_pad`` nodes
    (the tail's features zero, label 0, masked out) and ``e_pad`` edges,
    the padding edges self-loops on the dead tail nodes."""
    import numpy as np
    n, e = g["labels"].shape[0], g["edge_src"].shape[0]
    dead = np.arange(n, n_pad, dtype=np.int32)
    check(len(dead) > 0 and e <= e_pad, f"{n} nodes and {e} edges pad to "
          f"{n_pad} and {e_pad} with self-loops on dead tail nodes")
    loops = dead[np.arange(e_pad - e) % len(dead)]
    feats = np.zeros((n_pad, g["feats"].shape[1]), np.float32)
    feats[:n] = g["feats"]
    labels = np.zeros(n_pad, np.int32)
    labels[:n] = g["labels"]
    mask = np.zeros(n_pad, bool)
    mask[:n] = g["mask"]
    return {"feats": feats,
            "edge_src": np.concatenate([g["edge_src"], loops]),
            "edge_dst": np.concatenate([g["edge_dst"], loops]),
            "labels": labels, "mask": mask}


def gnn_data(shape, structs: dict, n_out: int) -> tuple[dict, int]:
    """The host batch of one cell, from ``data/graph.py`` and the seed, at
    the shape's registered size, and its count of real nodes (roots,
    graphs) a step.  full_graph_sm: ``cora_like``; ogb_products: a
    power-law graph of 2,449,029 nodes and 61,859,140 edges plus
    self-loops, 100 features, 47 classes, the public split's count of
    training nodes; minibatch_lg: a ``NeighborSampler`` block of 1,024
    roots over a 232,965-node, 114,615,892-edge graph, fanout (15, 10);
    molecule: ``molecule_batch``."""
    import numpy as np
    from repro_torch.data.graph import (CSR, NeighborSampler, cora_like,
                                        molecule_batch, random_graph)
    rng = np.random.default_rng(SEED + 70)
    N = structs["feats"].shape[0]
    if shape.name == "full_graph_sm":
        g = cora_like(SEED)
        return pad_graph(g, N, structs["edge_src"].shape[0]), \
            g["labels"].shape[0]
    if shape.kind == "train_full":
        n, e, d = (shape.dim(k) for k in ("n_nodes", "n_edges", "d_feat"))
        src, dst = random_graph(SEED, n, e)
        mask = np.zeros(n, bool)
        mask[rng.choice(n, OGB_TRAIN_NODES, replace=False)] = True
        g = {"feats": rng.standard_normal((n, d), dtype=np.float32),
             "edge_src": src, "edge_dst": dst,
             "labels": rng.integers(0, n_out, n).astype(np.int32),
             "mask": mask}
        return pad_graph(g, N, structs["edge_src"].shape[0]), n
    if shape.kind == "train_sampled":
        n, e, d = (shape.dim(k) for k in ("n_nodes", "n_edges", "d_feat"))
        B = shape.dim("batch_nodes")
        src, dst = random_graph(SEED, n, e)
        sampler = NeighborSampler(CSR(src, dst, n), shape.dim("fanout"),
                                  seed=SEED)
        del src, dst
        block = sampler(0, rng.choice(n, B, replace=False))
        feats = rng.standard_normal((N, d), dtype=np.float32)
        feats[n:] = 0.0                  # the store's padding rows
        return {"feats": feats, **block,
                "labels": rng.integers(0, n_out, B).astype(np.int32)}, B
    B = shape.dim("batch")
    return molecule_batch(SEED, B, shape.dim("n_nodes"), shape.dim("n_edges"),
                          shape.dim("d_feat"), n_out), B


def gnn_grads_agree(torch, loss_a, grads_a, loss_b, grads_b) -> dict:
    """``a`` against ``b``: the loss's relative difference and each
    gradient leaf's largest difference over its largest |b value|, beside
    the bounds."""
    rel = {f"{layer}.{k}": float((grads_a[layer][k].cpu() -
                                  grads_b[layer][k].cpu()).abs().max()) /
           float(grads_b[layer][k].abs().max()) for layer, k in GNN_LEAVES}
    return {"loss": float(loss_a), "loss_ref": float(loss_b),
            "loss_rel_err": abs(float(loss_a) - float(loss_b)) /
            abs(float(loss_b)), "loss_bound": GNN_LOSS_RTOL,
            "grad_rel_err": rel, "grad_bound": GNN_GRAD_RTOL,
            "ok": abs(float(loss_a) - float(loss_b)) <=
            GNN_LOSS_RTOL * abs(float(loss_b))
            and max(rel.values()) <= GNN_GRAD_RTOL}


def gnn_loss_fn(cfg, kind: str):
    """The loss the cell of ``kind`` steps on: the edge-parallel GAT for
    ``train_full``, else the plain loss of the kind."""
    from repro_torch.models import gnn
    from repro_torch.models.gnn_ep import GNNEPInfo, loss_full_ep
    if kind == "train_full":
        return lambda p, b: loss_full_ep(p, b, cfg, GNNEPInfo())
    return lambda p, b: gnn.LOSS_BY_KIND[kind](p, b, cfg)


def gnn_card_vs_host(torch, cfg, kind, params, batch, host,
                     step0_loss: float) -> dict:
    """The first step's loss and every gradient leaf on the card (the
    cell's loss) against the plain path on the CPU, from the same inputs
    and weights."""
    from repro_torch.models import gnn
    from repro_torch.training.train_loop import value_and_grad
    from repro_torch.tree import tree_map
    loss_c, grads_c = value_and_grad(gnn_loss_fn(cfg, kind), params, batch)
    loss_h, grads_h = value_and_grad(
        lambda p, b: gnn.LOSS_BY_KIND[kind](p, b, cfg),
        tree_map(lambda t: t.cpu(), params),
        {k: torch.from_numpy(v) for k, v in host.items()})
    out = gnn_grads_agree(torch, loss_c, grads_c, loss_h, grads_h)
    out["step0_loss"] = step0_loss
    out["step0_rel_err"] = abs(step0_loss - float(loss_h)) / abs(
        float(loss_h))
    out["ok"] = out["ok"] and out["step0_rel_err"] <= GNN_LOSS_RTOL
    return out


def gnn_ogb_check(torch, dev, cfg, params, batch, host, n: int) -> dict:
    """ogb_products' chunked edge-parallel loss against the unchunked
    plain ``gnn.loss_full``, both on the card, on the first
    ``GNN_OGB_CHECK_EDGES`` edges plus the self-loops of the real nodes."""
    import numpy as np
    from repro_torch.models import gnn
    from repro_torch.models.gnn_ep import edge_chunk
    from repro_torch.training.train_loop import value_and_grad
    loops = np.arange(n, dtype=np.int32)
    sub = dict(batch)
    for k in ("edge_src", "edge_dst"):
        sub[k] = torch.as_tensor(np.concatenate(
            [host[k][:GNN_OGB_CHECK_EDGES], loops]), device=dev)
    E = sub["edge_src"].shape[0]
    n_out = params["l2"]["a_src"].shape[1]
    chunks = -(-E // edge_chunk(cfg.n_heads, n_out, torch.float32))
    loss_c, grads_c = value_and_grad(gnn_loss_fn(cfg, "train_full"), params,
                                     sub)
    torch.cuda.synchronize()
    loss_p, grads_p = value_and_grad(
        lambda p, b: gnn.loss_full(p, b, cfg), params, sub)
    torch.cuda.synchronize()
    out = gnn_grads_agree(torch, loss_c, grads_c, loss_p, grads_p)
    out.update(edges=E, layer2_chunks=chunks,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def gnn_cell(torch, dev, spec, shape, mesh) -> dict:
    """One cell through ``steps.build_cell``: its host data, the warm-up
    and timed steps, the card against the host (or, for ogb_products, the
    chunked against the plain loss on the card), and one step under the
    profiler (not for molecule)."""
    import numpy as np
    from repro_torch.launch.steps import build_cell
    from repro_torch.models import gnn
    from repro_torch.models.gnn_ep import edge_chunk
    from repro_torch.training.optimizer import AdamW
    cfg = spec.config
    cell = build_cell(spec, shape, mesh)
    pstructs, _, structs = cell.args
    d, n_out = pstructs["l1"]["W"].shape[0], pstructs["l2"]["a_src"].shape[1]
    t0 = time.perf_counter()
    host, units = gnn_data(shape, structs, n_out)
    data_s = time.perf_counter() - t0
    check(set(host) == set(structs) and all(
        tuple(host[k].shape) == tuple(s.shape)
        and host[k].dtype.name == str(s.dtype).removeprefix("torch.")
        for k, s in structs.items()),
        f"{cell.name}: host data in {data_s:.1f} s, every input of the "
        f"shape and dtype input_structs gives "
        f"({ {k: tuple(v.shape) for k, v in host.items()} })")
    params = gnn.init_params(torch.Generator(dev).manual_seed(SEED), cfg, d,
                             n_out)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    out = {"data_s": data_s, "n_out": n_out, "units_per_step": units,
           "model_flops": cell.model_flops}
    if shape.kind == "train_full":
        E = host["edge_src"].shape[0]
        out["edges"] = E
        out["edge_chunks"] = [-(-E // edge_chunk(cfg.n_heads, f,
                                                 torch.float32))
                              for f in (cfg.d_hidden, n_out)]
    if shape.name == "ogb_products":
        torch.cuda.reset_peak_memory_stats()
        out["chunked_vs_plain"] = gnn_ogb_check(torch, dev, cfg, params,
                                                batch, host, units)
        c = out["chunked_vs_plain"]
        check(c["ok"], f"{cell.name}: the chunked edge-parallel loss "
              f"({c['layer2_chunks']} layer-2 chunks) against the plain loss "
              f"on the card, {c['edges']:,} edges: loss rel err "
              f"{c['loss_rel_err']:.3g} (bound {GNN_LOSS_RTOL:g}), largest "
              f"gradient rel err {max(c['grad_rel_err'].values()):.3g} "
              f"(bound {GNN_GRAD_RTOL:g}); peak {c['peak_gb']:.2f} GB")
        torch.cuda.empty_cache()

    opt_state = AdamW(lr=3e-4, weight_decay=0.01).init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p, losses, steps_s = params, [], []
    for _ in range(1 + GNN_STEPS):
        t0 = time.perf_counter()
        p, opt_state, loss = cell.fn(p, opt_state, batch)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"{cell.name}: {1 + GNN_STEPS} AdamW steps on one batch, finite "
          f"losses {[round(x, 5) for x in losses]}, step 0's loss falls")
    s_step = pct(steps_s[1:], 0.5)
    out.update(losses=losses, step_s=steps_s, step_s_p50=s_step,
               units_per_s=units / s_step,
               model_tflops_per_s=cell.model_flops / s_step / 1e12,
               fp32_peak_share=cell.model_flops / s_step / FP32_FLOPS_PER_S,
               peak_gb=peak)
    log(f"  {cell.name}: {s_step * 1e3:.2f} ms a step (p50 of {GNN_STEPS}; "
        f"warm-up {steps_s[0] * 1e3:.1f} ms), {out['units_per_s']:,.0f} "
        f"{'graphs' if shape.kind == 'train_batched' else 'nodes'}/s, "
        f"{out['model_tflops_per_s']:.3g} TFLOP/s of gnn_model_flops "
        f"({out['fp32_peak_share']:.2%} of 67), peak {peak:.2f} GB, host "
        f"data {data_s:.1f} s")
    if shape.name != "ogb_products":
        out["card_vs_host"] = gnn_card_vs_host(
            torch, cfg, shape.kind, params, batch, host, losses[0])
        c = out["card_vs_host"]
        check(c["ok"], f"{cell.name}: card against host: loss rel err "
              f"{c['loss_rel_err']:.3g} (step 0: {c['step0_rel_err']:.3g}; "
              f"bound {GNN_LOSS_RTOL:g}), largest gradient rel err "
              f"{max(c['grad_rel_err'].values()):.3g} (bound "
              f"{GNN_GRAD_RTOL:g})")
    if shape.name != "molecule":
        log("    one step under the profiler:")
        out["profile"] = device_share(
            torch, lambda: cell.fn(p, opt_state, batch), reps=1)
    del p, opt_state, batch, params
    torch.cuda.empty_cache()
    return out


def run_gnn(torch, dev) -> dict:
    """The four ``gat-cora`` cells at their registered sizes through
    ``steps.build_cell`` on a (1, 1) mesh over a one-rank NCCL process
    group (the ``train_full`` ones run its collectives).  Launch counts
    zeroed at the start and read at the end: the GNN path launches none
    of the seven kernels."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.mesh import one_rank_mesh
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_launch_counts()
    spec = get_arch("gat-cora")
    metrics = {}
    with one_rank_mesh() as mesh:
        for shape in spec.shapes:
            metrics[shape.name] = gnn_cell(torch, dev, spec, shape, mesh)
    counts = launch_counts()
    check(not any(counts.values()),
          f"the GNN path launched none of the seven kernels ({counts}); the "
          "kernels line does not count this phase")
    metrics["kernel_launches"] = counts
    metrics["host_data_s"] = sum(m["data_s"] for m in metrics.values()
                                 if isinstance(m, dict) and "data_s" in m)
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  host data {metrics['host_data_s']:.1f} s; phase "
        f"{metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# Phase 12b: the dry run and the roofline
# ---------------------------------------------------------------------------

# ``all_cells()`` on both production meshes: 41 cells counted on each, the
# three ``skip_shapes`` (long_500k of gemma-7b, granite-20b, olmoe-1b-7b)
# skipped on each.
DRYRUN_RECORDS, DRYRUN_OK, DRYRUN_SKIPPED = 88, 82, 6
DRYRUN_TIMEOUT_S = 600


def dry_run_without_card() -> dict:
    """``python -m repro_torch.launch.dryrun --all`` in a subprocess that
    sees no card (``CUDA_VISIBLE_DEVICES=""``): every record ok or
    skipped, as many as ``all_cells()`` gives on two meshes."""
    import os
    import tempfile
    with tempfile.TemporaryDirectory(prefix="dryrun-") as tmp:
        out = Path(tmp) / "dryrun.jsonl"
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "repro_torch.launch."
                              "dryrun", "--all", "--out", str(out)],
                             env=env, cwd=tmp, capture_output=True,
                             text=True, timeout=DRYRUN_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        recs = ([json.loads(ln) for ln in out.read_text().splitlines()]
                if out.exists() else [])
    status = [r["status"] for r in recs]
    for r in recs:
        if r["status"] != "ok":
            log(f"  {r['arch']}/{r['shape']}@{r['mesh']}: {r['status']}")
            continue
        t = r["roofline"]
        log(f"  {r['arch']}/{r['shape']}@{r['mesh']}: "
            f"{t['flops_per_device']:.4g} FLOP, {t['bytes_per_device']:.4g}"
            f" B, {t['coll_bytes_per_device']:.4g} B collective a device; "
            f"bound {max(t['t_compute_s'], t['t_memory_s'], t['t_collective_s']) * 1e3:.4g}"
            f" ms ({t['dominant']}); peak "
            f"{r['memory']['peak_bytes'] / 1e9:.3f} GB")
    check(res.returncode == 0 and "dry-run complete: all cells ok"
          in res.stdout and len(recs) == DRYRUN_RECORDS
          and status.count("ok") == DRYRUN_OK
          and status.count("skipped") == DRYRUN_SKIPPED,
          f"the dry run without the card: {len(recs)} records, "
          f"{status.count('ok')} ok, {status.count('skipped')} skipped, "
          f"{status.count('error')} errors in {seconds:.1f} s (rc "
          f"{res.returncode}; {res.stderr.strip()[-500:]})")
    return {"seconds": seconds, "records": len(recs),
            "ok": status.count("ok"), "skipped": status.count("skipped")}


def counted_on_card_and_meta(torch, fn, card_args, meta_args, name: str
                             ) -> dict:
    """``fn`` on the card under the counter (launches counted) and on
    ``meta`` under another; their FLOPs, bytes and kernel calls must be
    equal, and the card must have launched ``name`` once a counted call."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.trace import Counter
    torch.cuda.synchronize()
    reset_launch_counts()
    with torch.no_grad(), Counter() as card:
        out = fn(*card_args)
        torch.cuda.synchronize()
    launches = launch_counts()[name]
    with torch.no_grad(), Counter() as meta:
        fn(*meta_args)
    same = (card.flops, card.flops_f32, card.bytes, card.kernels) == (
        meta.flops, meta.flops_f32, meta.bytes, meta.kernels)
    calls = card.kernels.get(name, {}).get("calls", 0)
    check(same and launches == calls >= 1,
          f"{name}'s path counted on the card as on meta: "
          f"{card.flops + card.flops_f32:.6g} FLOP ({card.flops_f32:.6g} "
          f"fp32), {card.bytes:.6g} B, kernels {card.kernels} (meta: "
          f"{meta.flops + meta.flops_f32:.6g}, {meta.bytes:.6g} B, "
          f"{meta.kernels}); {launches} launches")
    return {"flops": card.flops + card.flops_f32, "flops_f32":
            card.flops_f32, "bytes": card.bytes, "kernels": card.kernels,
            "launches": launches, "out": out}


def roofline_of(spec, shape, mesh) -> dict:
    """The (1, 1)-mesh roofline of ``spec`` at ``shape``, counted on meta
    through ``jit_cell``."""
    from repro_torch.launch.roofline import analyze
    from repro_torch.launch.steps import build_cell, jit_cell
    cell = build_cell(spec, shape, mesh)
    compiled = jit_cell(cell, mesh).lower(*cell.args).compile()
    terms = analyze(compiled, cell.model_flops)
    return {**terms.as_dict(), "bound_s": terms.bound_time,
            "trace_s": compiled.seconds}


def run_roofline(torch, dev, measured: dict) -> dict:
    """(a) the dry run of every cell without the card; (b) one
    ``build_step`` at phase 9's 32,768 x 58,541 in bf16 and one xDeepFM
    serve_p99 forward on the card under the counter, each equal to its
    ``meta`` trace, the build's similarity FLOPs the kernel's formula;
    (c) the (1, 1)-mesh roofline of four cells earlier phases time on the
    card, at the sizes they run, and measured time / bound."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data import CTRStream
    from repro_torch.launch import trace
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import cf, recsys as rec
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    metrics = {"dry_run": dry_run_without_card()}
    log(f"  (a) dry run: {metrics['dry_run']}")

    # (b) counted on the card and on meta.
    g = torch.Generator(device=dev).manual_seed(SEED + 60)
    R = torch.randint(0, 6, (N_USERS, DOUBAN_ITEMS), device=dev,
                      generator=g).to(torch.bfloat16)
    build = counted_on_card_and_meta(
        torch, cf.build_step, (R,), (torch.empty_like(R, device="meta"),),
        "similarity")
    del build["out"], R
    torch.cuda.empty_cache()
    sim = build["kernels"]["similarity"]
    want = 2.0 * N_USERS ** 2 * DOUBAN_ITEMS
    check(sim["flops"] == want and sim["calls"] == 1,
          f"build_step's similarity call counts 2·{N_USERS}²·{DOUBAN_ITEMS}"
          f" = {want:.5g} FLOP ({sim['flops']:.5g}), "
          f"{want / BF16_FLOPS_PER_S * 1e3:.1f} ms at 989 TFLOP/s")
    metrics["build"] = build
    spec = get_arch("xdeepfm")
    params = rec.init_params(torch.Generator(device=dev).manual_seed(
        SEED + 61), spec.config)
    batch = to_device(torch, CTRStream(spec.config, spec.shape(
        "serve_p99").dim("batch"), seed=SEED + 62)(0), dev)
    batch.pop("label")
    to_meta = lambda t: torch.empty_like(t, device="meta")   # noqa: E731
    serve = counted_on_card_and_meta(
        torch, lambda p, b: rec.forward(p, b, spec.config), (params, batch),
        (tree_map(to_meta, params), tree_map(to_meta, batch)),
        "embedding_bag")
    check(bool(torch.isfinite(serve.pop("out")).all()),
          "the counted xDeepFM serve_p99 forward is finite")
    del params, batch
    torch.cuda.empty_cache()
    metrics["xdeepfm_serve"] = serve
    log(f"  (b) build_step: {build['flops']:.6g} FLOP, {build['bytes']:.6g}"
        f" B; xDeepFM serve_p99: {serve['flops']:.6g} FLOP, "
        f"{serve['bytes']:.6g} B; equal on the card and on meta")

    # (c) the roofline of four cells beside their measured times.
    cf_spec, lm_spec, gnn_spec = (get_arch(a) for a in (
        "twinsearch-cf", "gemma3-1b", "gat-cora"))
    cells = {
        "twinsearch-cf/build@32768": (cf_spec, ShapeSpec(
            "douban_build", "build", {"n_users": N_USERS,
                                      "n_items": DOUBAN_ITEMS}),
            measured["build_s"]),
        "xdeepfm/serve_p99": (spec, spec.shape("serve_p99"),
                              measured["serve_p99_ms"] / 1e3),
        "gemma3-1b/prefill_32k@batch1": (lm_spec, dataclasses.replace(
            lm_spec.shape("prefill_32k"), dims={
                **lm_spec.shape("prefill_32k").dims,
                "global_batch": LM_PREFILL_BATCH}),
            measured["prefill_32k_ms"] / 1e3),
        "gat-cora/ogb_products": (gnn_spec, gnn_spec.shape("ogb_products"),
                                  measured["ogb_products_s"]),
    }
    rooflines = {}
    with trace.fake_world(1):
        mesh = make_mesh((1, 1), ("data", "model"), device_type="cpu")
        for name, (sp, sh, seconds) in cells.items():
            r = roofline_of(sp, sh, mesh)
            r.update(measured_s=seconds, ratio=seconds / r["bound_s"])
            rooflines[name] = r
            log(f"  (c) {name}: measured {seconds * 1e3:.4g} ms, bound "
                f"{r['bound_s'] * 1e3:.4g} ms ({r['dominant']}: compute "
                f"{r['t_compute_s'] * 1e3:.4g}, memory "
                f"{r['t_memory_s'] * 1e3:.4g} ms), measured / bound "
                f"{r['ratio']:.4g}; useful {r['useful_fraction']:.3g}")
    metrics["cells"] = rooflines
    metrics["phase_s"] = time.perf_counter() - t_phase
    log(f"  phase {metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# Phase 13: MovieLens shape, card against CPU
# ---------------------------------------------------------------------------

def movielens_script(torch, device: str):
    import numpy as np
    from repro_torch.bridge import state_to_numpy
    from repro_torch.data.synthetic import movielens_100k, plant_twins
    from repro_torch.serving import CFServer, LadderConfig, ServerConfig
    from repro_torch.training.elastic import StragglerMonitor

    R = movielens_100k(SEED).astype(np.float32)
    rng = np.random.default_rng(SEED + 5)
    stream = [R[u] for u in rng.choice(943, size=10, replace=False)]
    stream += [plant_twins(R, 1, seed=SEED + 200 + i)[0].astype(np.float32)
               for i in range(4)]
    stream = stream + stream[:8]                   # 22 > 16 free: rotates
    monitor = StragglerMonitor(window=64, straggler_ratio=50.0,
                               hang_timeout_s=30.0, consecutive_to_shrink=3)
    srv = CFServer(R, ServerConfig(capacity_extra=16, c_probes=C_PROBES,
                                   ladder=LadderConfig(monitor=monitor)),
                   device=device)
    res = [srv.onboard_user(r) for r in stream]
    users = list(range(0, srv.state.n_active, 4))
    items = [u % 1682 for u in users]
    recs = srv.recommend_batch(users, n=10, k_neighbors=20)
    preds = srv.predict_batch(users, items, k=20)
    return {"results": res, "recs": recs, "preds": np.asarray(preds),
            "users": users, "items": items,
            "state": state_to_numpy(srv.state),
            "stats": srv.stats.summary()}


def run_movielens(torch) -> None:
    """The same script on the card and on the CPU.  The two runs build
    their arenas with different fp32 summation orders, so they are held to
    the parity tests' contract: statuses and twin flags exact, lists within
    1e-6.  The answers are held to it on the same inputs, as the query
    parity tests are: the card's answers against the plain path's answers
    from the card's own final state."""
    import numpy as np
    from repro_torch.bridge import (lists_match, ranked_match,
                                    state_from_numpy)
    from repro_torch.core import knn
    card = movielens_script(torch, DEVICE)
    host = movielens_script(torch, "cpu")
    check([(r.status, r.twin_found, r.user_id) for r in card["results"]]
          == [(r.status, r.twin_found, r.user_id) for r in host["results"]],
          "MovieLens statuses, twin flags and ids identical card vs CPU")
    cs, hs = card["stats"], host["stats"]
    check(cs["rotations"] == hs["rotations"] == 1
          and cs["twin_hits"] == hs["twin_hits"] > 0,
          f"MovieLens rotations and twin hits agree ({cs['twin_hits']} "
          "hits)")
    why = lists_match(host["state"]["sim_vals"], host["state"]["sim_idx"],
                      card["state"]["sim_vals"], card["state"]["sim_idx"],
                      1e-6)
    check(why is None, f"MovieLens lists agree within 1e-6 ({why})")
    check(np.array_equal(card["state"]["ratings"], host["state"]["ratings"]),
          "MovieLens ratings identical")
    # Answers from two arenas that differ within 1e-6 are not comparable at
    # 1e-6 (a near-tie at the k-th neighbour may pick another user): shown,
    # not checked.
    log(f"  card-built vs CPU-built answers: prediction max diff "
        f"{np.abs(card['preds'] - host['preds']).max():.3g}")

    plain = state_from_numpy(card["state"], "cpu")
    vals, items = knn.recommend_batch(plain, card["users"], 20, 10)
    why = ranked_match(vals.numpy(), items.numpy(),
                       [[v for _, v in r] for r in card["recs"]],
                       [[i for i, _ in r] for r in card["recs"]], 1e-6)
    check(why is None, f"MovieLens recommendations: card = plain path on "
          f"the same state within 1e-6 ({why})")
    preds = knn.predict_batch(plain, card["users"], card["items"],
                              20).numpy()
    err = float(np.abs(preds - card["preds"]).max())
    check(err <= 1e-6, f"MovieLens predictions: card = plain path on the "
          f"same state within 1e-6 (max diff {err:.3g})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device(DEVICE)
    t_start = time.perf_counter()
    try:
        log("== 1. device")
        name = torch.cuda.get_device_name(0)
        smi = nvidia_smi_line()
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"device {name}")
        log(f"  nvidia-smi: {smi}")

        log("== 2. build")
        from repro_torch.kernels import build_all
        t0 = time.perf_counter()
        logs = build_all()
        log(f"  built {len(logs)} kernels in {time.perf_counter() - t0:.1f}"
            " s")
        for kname, text in logs.items():
            for line in text.splitlines():
                if "ptxas" in line or "spill" in line:
                    log(f"  [{kname}] {line.strip()}")

        log("== 3. kernels against their plain versions")
        entries = {"list_merge": check_list_merge(torch, dev)}
        torch.cuda.empty_cache()
        entries["list_merge"]["rows"] = check_list_merge_rows(torch, dev)
        torch.cuda.empty_cache()
        health = check_arena_health(torch, dev)
        t0 = time.perf_counter()
        R_host = douban_width_ratings()
        log(f"  synthesised {R_host.shape} ratings ({int((R_host != 0).sum())}"
            f" nonzero) in {time.perf_counter() - t0:.1f} s")
        arena = torch.zeros((N_USERS + CAPACITY_EXTRA, DOUBAN_ITEMS),
                            device=dev)
        arena[:N_USERS] = torch.as_tensor(R_host, device=dev)
        entries["similarity"] = check_similarity(torch, dev, arena, R_host)
        entries["knn_score"] = check_knn_score(torch, dev, arena)
        entries["key_dedup"] = check_key_dedup(torch, dev, arena)
        del arena
        torch.cuda.empty_cache()

        log("== 4. server at Douban width")
        server, srv = run_server(torch, dev, R_host)
        torch.cuda.empty_cache()

        log("== 5. kernel API")
        api, api_launches = run_kernel_api(torch, dev, srv, R_host)
        entries.update(api)
        del srv
        torch.cuda.empty_cache()

        log("== 6. durability at Douban width")
        durability = run_durability(torch, dev, R_host, server["rotation_ms"])
        torch.cuda.empty_cache()

        log("== 7. replication at Douban width")
        replication = run_replication(torch, dev, R_host)
        torch.cuda.empty_cache()

        log("== 8. buffered burst at Douban width")
        buffered = run_buffered(torch, dev, R_host, server["burst_ms"])
        torch.cuda.empty_cache()

        log("== 9. CF model family and sharded burst at Douban width")
        cf_family = run_cf_family(torch, dev, R_host, buffered["burst_ms"])
        torch.cuda.empty_cache()

        log("== 10. recsys family and training substrate")
        recsys = run_recsys(torch, dev)
        torch.cuda.empty_cache()

        log("== 11. LM family at full width")
        lm = run_lm(torch, dev)
        torch.cuda.empty_cache()

        log("== 11b. OLMoE through expert parallelism (moe_ep)")
        moe_ep = run_moe_ep(torch, dev)
        torch.cuda.empty_cache()

        log("== 12. GNN family at full width")
        gnn = run_gnn(torch, dev)
        torch.cuda.empty_cache()

        log("== 12b. dry run and roofline")
        roof = run_roofline(torch, dev, {
            "build_s": cf_family["build_s"],
            "serve_p99_ms": recsys["serve_p50_ms"],
            "prefill_32k_ms": lm["gemma3_cells"]["prefill_32k"]["ms"],
            "ogb_products_s": gnn["ogb_products"]["step_s_p50"]})
        torch.cuda.empty_cache()

        log("== 13. MovieLens shape, card against CPU")
        run_movielens(torch)

        log("== 14. summary")
        main_phases = (server, durability, replication, buffered, cf_family)
        kernels = []
        for kname in MAIN_PATH + API_KERNELS:
            e = dict(entries[kname])
            e["launches"] = (sum(ph["launches"][kname] for ph in main_phases)
                             if kname in MAIN_PATH else api_launches[kname])
            if kname == "embedding_bag":
                e["launches"] += (recsys["embedding_bag_launches"]
                                  + roof["xdeepfm_serve"]["launches"])
                e["recsys_path"] = recsys["bag_path"]
            if kname == "list_merge":
                e["plan_merge"] = durability["plan_merge"]
            if kname == "verify_rows":
                e["arena_health"] = health
                e["server_launches"] = server["launches"]["verify_rows"]
            if kname == "similarity":
                e["build"] = cf_family["build_kernel"]
                e["launches"] += roof["build"]["launches"]
            kernels.append(e)
        total_s = time.perf_counter() - t_start
        log(f"  total {total_s:.1f} s")
        print(json.dumps({"server": server, "total_s": total_s}))
        print(json.dumps({"durability": durability}))
        print(json.dumps({"replication": replication}))
        print(json.dumps({"buffered": buffered}))
        print(json.dumps({"cf_family": cf_family}))
        print(json.dumps({"recsys": recsys}))
        print(json.dumps({"lm": lm}))
        print(json.dumps({"moe_ep": moe_ep}))
        print(json.dumps({"gnn": gnn}))
        print(json.dumps({"roofline": roof}))
        print(json.dumps({"kernels": kernels}))
        print(nvidia_smi_line())
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    except CheckFailed as e:
        print(f"chip_smoke: check failed: {e}", file=sys.stderr)
    except Exception:                  # noqa: BLE001 — report, then fail
        traceback.print_exc()
    return 1


if __name__ == "__main__":
    sys.exit(main())
