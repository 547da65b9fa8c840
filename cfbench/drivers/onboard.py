"""Traffic kind ``onboard``: new users arriving open-loop at a fixed rate,
each through ``CFServer.onboard_user``.

Set-up: the configuration's ratings on the device, the server built from
them, then one write region of the mix plus one more request onboarded
(a twin copy, a fresh profile, and a synchronous rotation warmed).  The
window: ``round(rate * seconds)`` requests on the mix's schedule
(``arrivals``, Poisson by default).

Correct: every onboarded user's list (warm-up and window) and a seeded
sample of base rows, read from the arena after the window, against the
reference's exact cosine similarities over the ratings the benchmark
sent; twin flags against which requests were copies; the arena's base
and capacity against the stated growth.
"""
from __future__ import annotations

import gc

import torch

from cfbench import data, openloop, reference, serve
from cfbench.bench import Check, derive_seed

STATS = ("onboarded", "twin_hits", "fallbacks", "overflows", "rotations",
         "rejected", "shed", "errors", "rollbacks", "snapshots")


def setup(ctx, tracer) -> dict:
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    R = data.synth_ratings(cfg, derive_seed(ctx.seed, 1), dev)
    coo = data.to_coo(R)
    ctx.lap("ratings synthesised")
    n_req = data.count_requests(mix["rate_per_s"], ctx.seconds)
    n_warm = cfg["server"]["capacity_extra"] + 1
    traffic = serve.Onboarding(cfg, mix, R, ctx.seed,
                               {"warm": n_warm, "window": n_req}, dev)
    srv = serve.make_server(cfg, R, dev)
    del R
    ctx.lap("server built")
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 13))
    due = data.due_times(mix, n_req, ctx.seconds, gen)
    st = {"srv": srv, "coo": coo, "traffic": traffic, "due": due,
          "appended": []}
    for req in traffic.plans["warm"]:
        res = srv.onboard_user(traffic.payload(req))
        if res.ok:
            st["appended"].append((res.user_id, req))
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return st


def window(ctx, st, tracer) -> dict:
    srv, traffic = st["srv"], st["traffic"]
    plan = traffic.plans["window"]
    before = {k: getattr(srv.stats, k) for k in STATS}

    def call(i):
        cap = srv.state.capacity
        res = srv.onboard_user(traffic.payload(plan[i]))
        return serve.onboard_record(res, srv, cap)

    reqs = openloop.run(st["due"], call, tracer, "cfbench.onboard_user")
    for req, r in zip(plan, reqs):
        r["kind"] = req[0]
        if r["result"]["status"] == "ok":
            st["appended"].append((r["result"]["user_id"], req))
    ctx.note(openloop.lateness_note(reqs))
    ctx.note(openloop.queue_note(reqs, [r["result"]["latency_ms"]
                                        for r in reqs]))
    rot = [r["result"]["rotation_ms"] for r in reqs
           if r["result"]["rotation_ms"] is not None]
    ctx.note(f"rotations {len(rot)}, mean {sum(rot) / max(1, len(rot)):.4f}"
             f" ms; capacity at the end {srv.state.capacity}")
    return {"kind": "onboard", "requests": reqs,
            "stats": {k: getattr(srv.stats, k) - before[k] for k in STATS},
            "attempted": len(reqs),
            "failed": sum(r["result"]["status"] != "ok" for r in reqs)}


def _collect(ctx, st, records) -> None:
    """Read what the program answered (lists, geometry, twin flags), then
    free its state and make the reference's ratings on the device."""
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    srv = st["srv"]
    n0, m = cfg["n_users"], cfg["n_items"]
    extra = cfg["server"]["capacity_extra"]
    appended = sorted(st["appended"])
    n_act = n0 + len(appended)
    n_base, cap = serve.expected_geometry(n0, extra, len(appended))
    geometry = int(srv.n_base != n_base) + int(srv.state.capacity != cap) \
        + int(srv.state.n_active != n_act) \
        + sum(int(u != n0 + j) for j, (u, _) in enumerate(appended))
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 14))
    base = torch.randperm(n_base, generator=gen)[:mix["check_base_rows"]]
    rows = torch.cat([base, torch.arange(n0, n_act)]).to(dev)
    rows = rows[rows < srv.state.n_active]
    vals = srv.state.sim_vals[rows].clone()
    idx = srv.state.sim_idx[rows].clone()

    reqs = records["requests"]
    twin_on = [r for r in reqs if r["result"]["rung"] == "twinsearch"]
    false_pos = sum(r["kind"] == "fresh" and r["result"]["twin"]
                    for r in reqs)
    false_neg = sum(r["kind"] == "copy" and r["result"]["status"] == "ok"
                    and not r["result"]["twin"] for r in twin_on)
    twin_errors = false_pos + max(0, false_neg
                                  - records["stats"]["overflows"])
    ctx.note(f"onboard check: {rows.numel()} rows ({len(appended)} "
             f"onboarded, {base.numel()} base), twin misses {false_neg} "
             f"(overflows {records['stats']['overflows']}), "
             f"{len(reqs) - len(twin_on)} requests off the twinsearch rung")

    # The program's state goes before the reference runs on the card.
    st["srv"] = srv = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    F = data.dense_rows(st["coo"], n_act, m, dev)
    for j, (_, req) in enumerate(appended):
        F[n0 + j] = torch.as_tensor(st["traffic"].payload(req), device=dev)
    st["judged"] = {"rows": rows, "vals": vals, "idx": idx, "F": F,
                    "cols": reference.expected_columns(rows, n_base),
                    "geometry": geometry, "twin_errors": twin_errors}


def check(ctx, st, records, control: str | None = None) -> list[Check]:
    """Judge the arena after the window; with ``control`` (a precision),
    the reference's own lists at that precision stand in for the
    arena's."""
    if "judged" not in st:
        _collect(ctx, st, records)
    j = st["judged"]
    e = reference.judge_lists(j["rows"], j["F"], j["cols"], "exact",
                              j["vals"], j["idx"], control=control)
    lim = ctx.mix["limits"]
    return [Check("sim_gap", e["gap"], lim["sim_gap"]),
            Check("list_id_rows", e["id_rows"], 0),
            Check("unsorted_rows", e["unsorted_rows"], 0),
            Check("twin_flag_errors", j["twin_errors"], 0),
            Check("geometry_errors", j["geometry"], 0)]
