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
               tile variant each), and bit for bit on integer ratings.
  4. server  — ``CFServer`` at Douban-film width (58,541 items at
               douban_film's density, 32,768 users): build, 48 planted
               twins + 16 fresh profiles into the 64-slot write buffer, one
               more onboard that rotates the arena, ``recommend_batch`` and
               ``predict_batch`` for 256 users, and a 32-user traditional
               burst on a clone of the state.  The launch counts are
               zeroed just before and read just after: every kernel of the
               path (similarity, list_merge, knn_score) must have run.
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
 10. movielens — the same request script at 943 x 1,682 on the card and on
               the CPU (the plain versions), held to the parity tests'
               tolerances.
 11. summary — ``{"kernels": [...]}`` (all six kernels, each with the
               launches of the phases that drove it: 4, 6, 7, 8 and 9 for
               the main path's three, 5 for the others), the nvidia-smi
               line, and last ``{"ok": true, "device": {...}}``.

It imports neither ``jax`` nor the JAX package, and refuses to run (exit 2)
without a CUDA device or without ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
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
C_PROBES = 8
DEVICE = "cuda"
# Kernel checks at the main path's shapes: the rotation's merge over the
# base rows (checked in one launch), the similarity product of 64 and of 32
# (the burst) users against the arena, and a 256-user recommend batch at
# k = 20.
MERGE_SHAPE = (N_USERS, N_USERS + 2 * CAPACITY_EXTRA, CAPACITY_EXTRA)
SIM_NQS = (64, 32)               # the 64-row tile; the server's burst
KNN_B, KNN_K = 256, 20
BURST = 32
# Phase 6: rotation slices of 4,096 base rows (8 slices for 32,768 rows); a
# checkpoint every 32 onboards (one mid-run, before the plan starts); 32
# add_ratings.
DUR_BUDGET_ROWS, DUR_SNAPSHOT_EVERY, DUR_ADDS = 4096, 32, 32
# Phase 7: 4 shards, 2 copies each, re-replication 4,096 rows a request; 12
# onboards before node 1 dies.
REP_SHARDS, REP_R, REP_REBUILD_ROWS, REP_ONBOARDS = 4, 2, 4096, 12
MAIN_PATH = ("similarity", "list_merge", "knn_score")
API_KERNELS = ("twin_probe", "verify_rows", "embedding_bag")
# xDeepFM's table and traffic come from ``repro_torch.configs`` (39
# power-law fields, 60,802,963 rows in all, the first 10M; 10 columns;
# RECSYS_SHAPES "serve_bulk", 262,144 rows per batch).  The multi-hot
# field's traffic is the reference's data/recsys_stream.py rule, not
# ported yet: 8 Zipf(1.3) ids each, valid with probability 0.6.
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


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: bytes over the memory rate or
    operations over the fp32 rate, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
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


def check_similarity(torch, dev, arena, R_host) -> dict:
    """Both tile variants on the Douban-width arena: nq = 64 (the 64-row
    tile) and nq = 32 (the 32-row tile, the server's burst width), each
    against its plain version in f32 and bf16 and timed beside
    ``torch.matmul`` (kernel, matmul, matmul, kernel); then the burst's 32
    fresh profiles and 64 such rows (integer ratings) bit for bit."""
    import numpy as np
    from repro_torch.data.synthetic import plant_twins
    from repro_torch.kernels.similarity.kernel import (entry_point,
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
    Rb = arena.bfloat16()
    variants = {}
    for nq in SIM_NQS:
        Q = torch.randn((nq, m), device=dev, generator=g)
        qn = torch.sqrt(torch.sum(torch.square(Q), dim=1)).clamp_min(EPS)
        out = similarity_cuda(Q, arena, qn, rn)
        err = float((out - similarity_ref(Q, arena, qn, rn)).abs().max())
        check(err <= 1e-5, f"similarity f32 ({nq} x {n} x {m}, "
              f"{entry_point(Q.dtype, nq)}) within 1e-5 (max err {err:.3g})")
        Qb = Q.bfloat16()
        err_b = float((similarity_cuda(Qb, Rb, qn, rn)
                       - similarity_ref(Qb, Rb, qn, rn)).abs().max())
        check(err_b <= 2e-2, f"similarity bf16 ({nq} x {n} x {m}, "
              f"{entry_point(Qb.dtype, nq)}) within 2e-2 (max err "
              f"{err_b:.3g})")
        del out
        kernel = lambda: similarity_cuda(Q, arena, qn, rn)   # noqa: E731
        matmul = lambda: torch.matmul(Q, arena.T)            # noqa: E731
        turns = [cuda_ms(kernel, 5), cuda_ms(matmul, 5), cuda_ms(matmul, 5),
                 cuda_ms(kernel, 5)]
        ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        ms_b = cuda_ms(lambda: similarity_cuda(Qb, Rb, qn, rn), reps=3)
        plain_ms = cuda_ms(lambda: similarity_ref(Q, arena, qn, rn), reps=3)
        flops = 2.0 * nq * n * m
        moved = 4.0 * (nq * m + n * m + nq * n + nq + n)
        b_ms, b_by = bound(moved, flops)
        log(f"  similarity f32 ({nq}x{n}x{m}, {entry_point(Q.dtype, nq)}): "
            f"kernel {ms:.3f} ms ({turns[0]:.3f}, {turns[3]:.3f}; "
            f"{flops / ms / 1e9:.1f} TFLOP/s, {moved / ms / 1e6:.0f} GB/s, "
            f"{b_ms / ms:.0%} of the bound), torch.matmul {lib_ms:.3f} ms "
            f"({turns[1]:.3f}, {turns[2]:.3f}), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by}); bf16 kernel {ms_b:.3f} ms")
        variants[str(nq)] = {
            "entry": entry_point(Q.dtype, nq), "shape": [nq, n, m],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "bf16_ms": ms_b, "bf16_max_abs_err": err_b, "turns_ms": turns}
    del Rb

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is off for the plain version's fp32 matmul")
    fresh = np.stack([plant_twins(R_host, 1, seed=SEED + 100 + i)[0]
                      for i in range(16, 16 + 64)]).astype(np.float32)
    for k in (BURST, 64):
        Qi = torch.as_tensor(fresh[:k], device=dev)
        qn = torch.sqrt(torch.sum(torch.square(Qi), dim=1)).clamp_min(EPS)
        check(torch.equal(similarity_cuda(Qi, arena, qn, rn),
                          similarity_ref(Qi, arena, qn, rn)),
              f"similarity on {k} fresh integer-rating profiles x {n} x {m} "
              f"({entry_point(Qi.dtype, k)}) bit-identical to the plain "
              "version")
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


def run_durability(torch, dev, R_host, sync_rotation_ms: float) -> dict:
    """A durable server at Douban width: WAL (fsync on) and checkpoints on
    local disk, incremental rotation in 4,096-row slices, add_ratings on
    base rows and on frozen burst rows while the plan is in flight, the
    swap; then the live state copied to the host, the server dropped (the
    crash), and ``CFServer.recover`` held to the copy leaf by leaf.  The
    times are the servers' own ``ServerStats``; the plan's merge is held
    to the plain path on its own inputs afterwards."""
    import shutil
    import tempfile
    import zlib
    import numpy as np
    from repro_torch.bridge import FIELDS
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.serving import (CFServer, LadderConfig, RotationConfig,
                                     ServerConfig, SnapshotConfig, WalConfig)
    from repro_torch.training.elastic import StragglerMonitor

    capacity = N_USERS + CAPACITY_EXTRA
    arena_bytes = capacity * (DOUBAN_ITEMS + 1 + 2 * capacity) * 4
    # The temporary directory goes where there is more room: the system's
    # temporary directory or the checkout's build directory.
    places = [Path(tempfile.gettempdir()), ROOT / "build"]
    for place in places:
        place.mkdir(parents=True, exist_ok=True)
        u = shutil.disk_usage(place)
        log(f"  {place}: {u.free / 1e9:.1f} GB free of {u.total / 1e9:.1f} "
            "GB")
    place = max(places, key=lambda p: shutil.disk_usage(p).free)
    root = tempfile.mkdtemp(prefix="chip_smoke_durability_", dir=place)
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
        "users": N_USERS, "items": DOUBAN_ITEMS, "dir": str(place),
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
        out = cf.onboard_step(local, R_new, probes, cfg, distributed=True)
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
                               distributed=True)
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
    log(f"  build_step {build_s:.2f} s (torch.matmul of the fp32 copies "
        f"{metrics['matmul_s']:.2f} s); sharded burst of {k}, first calls: "
        f"{sharded_ms:.1f} ms, maintain=True {sharded_m_ms:.1f} ms (phase "
        f"8's buffered burst of 32: {buffered_ms:.1f} ms); peak "
        f"{peak / 1e9:.2f} GB; phase {metrics['phase_s']:.1f} s")
    return metrics


def check_cf_build(torch, dev, R_b, vals, idx, build_s: float) -> dict:
    """``build_step``'s lists against a plain computation on the CPU for
    a 4,096-row slice (within 1e-5, ids except near-ties); the kernel's
    product timed beside ``torch.matmul`` on fp32 copies, TF32 off."""
    from repro_torch.bridge import lists_match
    from repro_torch.core.knn import SORT_CHUNK_ROWS, sort_rows
    from repro_torch.core.similarity import EPS, row_norms
    from repro_torch.kernels.similarity.kernel import similarity_cuda
    N, m = R_b.shape
    Rf = R_b.float()
    Rn = (Rf / torch.clamp_min(row_norms(Rf), EPS)[:, None]).to(R_b.dtype)
    del Rf
    rows = slice(0, SORT_CHUNK_ROWS)
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
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    S = similarity_cuda(Rn, Rn, ones, ones)
    end.record()
    end.synchronize()
    kernel_ms = start.elapsed_time(end)
    del S
    torch.backends.cuda.matmul.allow_tf32 = False
    Rf = Rn.float()
    del Rn
    start.record()
    S = torch.matmul(Rf, Rf.T)
    end.record()
    end.synchronize()
    matmul_ms = start.elapsed_time(end)
    del S, Rf
    torch.cuda.empty_cache()
    # The operations over the peak rate of the inputs' type: bf16 inputs
    # against the tensor cores' bf16 rate, though the kernel multiplies on
    # the CUDA cores in fp32.
    flops = 2.0 * N * N * m
    if R_b.dtype == torch.bfloat16:
        flops *= FP32_FLOPS_PER_S / BF16_FLOPS_PER_S
    moved = 2.0 * R_b.element_size() * N * m + 4.0 * 2 * N + 4.0 * N * N
    b_ms, b_by = bound(moved, flops)
    log(f"  build_step ({N} x {m}, {R_b.dtype}): {build_s:.2f} s; its "
        f"similarity launch {kernel_ms:.1f} ms ({b_ms / kernel_ms:.0%} of the"
        f" bound, {b_ms:.1f} ms, {b_by}); torch.matmul of fp32 copies "
        f"{matmul_ms:.1f} ms")
    return {"build_s": build_s, "matmul_s": matmul_ms / 1e3,
            "build_kernel": {"shape": [N, N, m], "dtype": str(R_b.dtype),
                             "ms": kernel_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": matmul_ms,
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
# Phase 10: MovieLens shape, card against CPU
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
        t0 = time.perf_counter()
        R_host = douban_width_ratings()
        log(f"  synthesised {R_host.shape} ratings ({int((R_host != 0).sum())}"
            f" nonzero) in {time.perf_counter() - t0:.1f} s")
        arena = torch.zeros((N_USERS + CAPACITY_EXTRA, DOUBAN_ITEMS),
                            device=dev)
        arena[:N_USERS] = torch.as_tensor(R_host, device=dev)
        entries["similarity"] = check_similarity(torch, dev, arena, R_host)
        entries["knn_score"] = check_knn_score(torch, dev, arena)
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

        log("== 10. MovieLens shape, card against CPU")
        run_movielens(torch)

        log("== 11. summary")
        main_phases = (server, durability, replication, buffered, cf_family)
        kernels = []
        for kname in MAIN_PATH + API_KERNELS:
            e = dict(entries[kname])
            e["launches"] = (sum(ph["launches"][kname] for ph in main_phases)
                             if kname in MAIN_PATH else api_launches[kname])
            if kname == "list_merge":
                e["plan_merge"] = durability["plan_merge"]
            if kname == "similarity":
                e["build"] = cf_family["build_kernel"]
            kernels.append(e)
        total_s = time.perf_counter() - t_start
        log(f"  total {total_s:.1f} s")
        print(json.dumps({"server": server, "total_s": total_s}))
        print(json.dumps({"durability": durability}))
        print(json.dumps({"replication": replication}))
        print(json.dumps({"buffered": buffered}))
        print(json.dumps({"cf_family": cf_family}))
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
