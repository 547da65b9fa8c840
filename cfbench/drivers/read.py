"""Traffic kind ``read``: recommendation batches arriving open-loop at a
fixed rate, each through ``CFServer.recommend_batch``.

Set-up: the configuration's ratings on the device, the server built from
them, one write region of the onboard mix onboarded (so twins of base
users and fresh users are readable), and a few read batches.  The
window: ``round(rate * seconds)`` calls on the mix's schedule
(``arrivals``: a batching front end's timer), each of
``batch`` users drawn Zipf(``zipf_s``) over the active users (the same
multiset of ranks for every seed, ranks mapped to users by a seeded
permutation).

Correct: every served row, judged against the reference's kNN scores
over the exact similarities among the rows its list covers (base users
see the base, users onboarded since the last rotation every earlier
row).  A row whose k-th and (k+1)-th reference neighbours lie within
``ambiguity`` is not judged, since a rounding may rightly pick either;
the count is reported.
"""
from __future__ import annotations

import gc

import torch

from cfbench import data, openloop, reference, serve
from cfbench.bench import Check, derive_seed

STATS = ("queries", "query_unique", "query_batches", "query_degraded",
         "rejected")


def setup(ctx, tracer) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    R = data.synth_ratings(cfg, derive_seed(ctx.seed, 1), dev)
    coo = data.to_coo(R)
    ctx.lap("ratings synthesised")
    traffic = serve.Onboarding(cfg, mix, R, ctx.seed,
                               {"warm": mix["write_region_onboards"]}, dev)
    srv = serve.make_server(cfg, R, dev)
    del R
    ctx.lap("server built")
    appended = []
    for req in traffic.plans["warm"]:
        res = srv.onboard_user(traffic.payload(req))
        if res.ok:
            appended.append((res.user_id, req))
    n_act = srv.state.n_active
    n_calls = data.count_requests(mix["rate_per_s"], ctx.seconds)
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 21))
    due = data.due_times(mix, n_calls, ctx.seconds, gen)
    ranks = data.zipf_ranks(n_calls * mix["batch"], n_act, mix["zipf_s"],
                            gen)
    users = torch.randperm(n_act, generator=gen)[ranks]
    batches = users.view(n_calls, mix["batch"]).tolist()
    warm = torch.randint(0, n_act, (mix["warm_calls"], mix["batch"]),
                         generator=gen).tolist()
    for b in warm:
        srv.recommend_batch(b, n=mix["n"], k_neighbors=mix["k_neighbors"])
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"srv": srv, "coo": coo, "traffic": traffic, "due": due,
            "batches": batches, "appended": appended}


def window(ctx, st, tracer) -> dict:
    srv, mix = st["srv"], ctx.mix
    before = {k: getattr(srv.stats, k) for k in STATS}

    def call(i):
        recs = srv.recommend_batch(st["batches"][i], n=mix["n"],
                                   k_neighbors=mix["k_neighbors"])
        return {"recs": recs, "query_ms": float(srv.stats.query_ms[-1]),
                "empty": sum(len(r) == 0 for r in recs)}

    reqs = openloop.run(st["due"], call, tracer, "cfbench.recommend_batch")
    ctx.note(openloop.lateness_note(reqs))
    ctx.note(openloop.queue_note(reqs, [r["result"]["query_ms"]
                                        for r in reqs]))
    return {"kind": "read", "requests": reqs,
            "stats": {k: getattr(srv.stats, k) - before[k] for k in STATS},
            "attempted": len(reqs),
            "failed": sum(r["result"]["empty"] > 0 for r in reqs)}


def _collect(ctx, st) -> None:
    """Read the arena's geometry, free the program's state and make the
    reference's ratings on the device."""
    cfg, dev = ctx.config, ctx.device
    srv = st["srv"]
    n0, m = cfg["n_users"], cfg["n_items"]
    n_act = srv.state.n_active
    n_base = srv.n_base
    appended = sorted(st["appended"])
    geometry = int(n_act != n0 + len(appended)) + int(
        n_base != serve.expected_geometry(
            n0, cfg["server"]["capacity_extra"], len(appended))[0])
    st["srv"] = srv = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    F = data.dense_rows(st["coo"], n_act, m, dev)
    for j, (_, req) in enumerate(appended):
        F[n0 + j] = torch.as_tensor(st["traffic"].payload(req), device=dev)
    st["judged"] = {"F": F, "n_base": n_base, "geometry": geometry}


def check(ctx, st, records, control: str | None = None) -> list[Check]:
    """Judge every served row; with ``control`` (a precision), the
    reference's own answers from similarities at that precision stand in
    for the served ones."""
    if "judged" not in st:
        _collect(ctx, st)
    mix, dev = ctx.mix, ctx.device
    F, n_base = st["judged"]["F"], st["judged"]["n_base"]
    n_act = F.shape[0]
    served = []                       # (user, recs) of every served row
    for i, r in enumerate(records["requests"]):
        served.extend(zip(st["batches"][i], r["result"]["recs"]))
    uniq = sorted({u for u, _ in served})
    where = {u: i for i, u in enumerate(uniq)}
    k, n = mix["k_neighbors"], mix["n"]
    agg = {"score_gap": 0.0, "rank_gap": 0.0, "malformed": 0}
    skipped = judged = 0
    block = 64
    for b0 in range(0, len(uniq), block):
        users = torch.tensor(uniq[b0:b0 + block], device=dev)
        cols = reference.expected_columns(users, n_base)
        cand = torch.arange(n_act, device=dev)[None, :] < cols[:, None]
        cand[torch.arange(users.numel(), device=dev), users] = False
        scores, amb = reference.knn_scores(
            reference.cosine_rows(F[users], F, "exact"), cand, F, users, k,
            mix["ambiguity"])
        if control is not None:
            ctrl, _ = reference.knn_scores(
                reference.cosine_rows(F[users], F, control), cand, F, users,
                k, mix["ambiguity"])
            answers = reference.served_from_reference(ctrl, n)
        rows, ref_rows = [], []
        for u, recs in served:
            i = where[u] - b0
            if not 0 <= i < users.numel():
                continue
            if bool(amb[i]):
                skipped += 1
                continue
            rows.append(answers[i] if control is not None else recs)
            ref_rows.append(i)
        judged += len(rows)
        if rows:
            g = reference.recommendation_gaps(rows, scores[ref_rows], n)
            agg["score_gap"] = max(agg["score_gap"], g["score_gap"])
            agg["rank_gap"] = max(agg["rank_gap"], g["rank_gap"])
            agg["malformed"] += g["malformed"]
    ctx.note(f"read check: {judged} served rows judged, {skipped} skipped "
             f"as ambiguous, {len(uniq)} distinct users")
    lim = mix["limits"]
    return [Check("rec_score_gap", agg["score_gap"], lim["rec_score_gap"]),
            Check("rec_rank_gap", agg["rank_gap"], lim["rec_rank_gap"]),
            Check("rec_malformed", agg["malformed"], 0),
            Check("geometry_errors", st["judged"]["geometry"], 0)]
