"""Traffic kind ``burst``: bursts of identical new rows arriving open-loop
at a fixed rate, each through ``repro_torch.models.cf.onboard_step`` (the
paper's TwinSearch burst over an immutable base arena).

Set-up: the configuration's ratings synthesised user-major on the device,
their nonzeros kept on the host laid out as the configuration's ``mode``
says (items as the arena's rows in item mode), the dense arena rows made
from them and the user-major copy freed, the arena built by
``core.knn.build_state`` (which takes the rows over), then one copy burst
and one fresh burst of ``warm_k`` rows.  The window: ``round(rate *
seconds)`` bursts on the mix's schedule (``arrivals``, Poisson by
default), k uniform over ``k_sweep`` and ``copy_share`` of them copies of
one of ``pool_size`` base rows with at least ``pool_min_ratings``
ratings, the rest a fresh profile rated by ``fresh_raters`` of the
arena's columns, with the same counts for every seed;
every row of a burst is a copy of its first.  A burst is sent as a host
array, as a client sends it, with probes from ``make_probes`` on a
generator seeded from the run's seed, and timed from its due time until
its rows and stats are read.

Records: kind ``onboard``, one request per burst row (its burst's due,
start and end), ``bursts`` (per burst: k, kind, times and its
``OnboardStats`` counts) and their totals under ``stats``; a burst is one
attempted operation.

Correct (``cfbench/reference_burst.py``, after the program's state is
freed): every row of every burst, warm-up included, against exact
cosines over the base and the burst's earlier rows; twin flags against
exact row equality; copies bit-equal to what they copied; each burst's
lists (k, n_base + k); the base's active count and every bit of its
ratings, norms and lists as before the window.
"""
from __future__ import annotations

import dataclasses
import gc
import inspect

import torch

from cfbench import data, openloop, reference_burst
from cfbench.bench import Check, derive_seed

COO_CHUNK_ROWS = 8192       # rows per nonzero scan (below 2**31 elements)


def arena_coo(R: torch.Tensor, mode: str
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """A host copy of the user-major R's nonzeros as ((nnz, 2) int32
    (arena row, column), (nnz,) values): (item, user) in item mode."""
    ij, vals = [], []
    for u0 in range(0, R.shape[0], COO_CHUNK_ROWS):
        block = R[u0:u0 + COO_CHUNK_ROWS]
        nz = torch.nonzero(block)
        vals.append(block[nz[:, 0], nz[:, 1]].cpu())
        nz[:, 0] += u0
        ij.append(nz.to(torch.int32).cpu())
    ij = torch.cat(ij)
    if mode == "item":
        ij = ij.flip(1).contiguous()
    return ij, torch.cat(vals)


def heavy_rows(coo, n_rows: int, size: int, min_ratings: int,
               gen: torch.Generator) -> torch.Tensor:
    """(size,) arena rows with at least ``min_ratings`` ratings, drawn
    without replacement (counted on the host copy)."""
    counts = torch.bincount(coo[0][:, 0].long(), minlength=n_rows)
    heavy = torch.nonzero(counts >= min_ratings).flatten()
    if heavy.numel() < size:
        raise ValueError(f"only {heavy.numel()} rows have >= {min_ratings} "
                         f"ratings; the pool needs {size}")
    return heavy[torch.randperm(heavy.numel(), generator=gen)[:size]]


def fresh_rows(cfg: dict, k: int, width: int, raters: int,
               gen: torch.Generator, device) -> torch.Tensor:
    """(k, width) f32 fresh rows: ``raters`` distinct columns each, chosen
    uniformly, values uniform over the rating scale (``data.fresh_profiles``
    with the count given)."""
    out = torch.zeros((k, width), dtype=torch.float32, device=device)
    if k == 0:
        return out
    cols = torch.topk(torch.rand((k, width), generator=gen, device=device),
                      raters, dim=1).indices
    levels = data.rating_levels(cfg).to(device)
    pick = torch.randint(0, levels.numel(), (k, raters), generator=gen,
                         device=device)
    out.scatter_(1, cols, levels[pick])
    return out


def plan_bursts(n: int, mix: dict, gen: torch.Generator
                ) -> list[tuple[str, int, int]]:
    """``n`` bursts as (kind, k, payload): round(copy_share n) copies,
    payload a pool slot in turn, the rest fresh, payload a fresh profile
    numbered from 0; each kind's k cycle through ``k_sweep``; in a seeded
    order."""
    ks = mix["k_sweep"]
    n_copy = int(round(mix["copy_share"] * n))
    out = [("copy", ks[i % len(ks)], i % mix["pool_size"])
           for i in range(n_copy)]
    out += [("fresh", ks[j % len(ks)], j) for j in range(n - n_copy)]
    return [out[i] for i in torch.randperm(n, generator=gen).tolist()]


def setup(ctx, tracer) -> dict:
    from repro_torch.configs.twinsearch_cf import CONFIG
    from repro_torch.core.knn import build_state
    from repro_torch.core.twinsearch import make_probes
    from repro_torch.models.cf import onboard_step
    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    item = cfg["mode"] == "item"
    n_rows, width = ((cfg["n_items"], cfg["n_users"]) if item
                     else (cfg["n_users"], cfg["n_items"]))
    R = data.synth_ratings(cfg, derive_seed(ctx.seed, 1), dev)
    coo = arena_coo(R, cfg["mode"])
    del R
    ctx.lap("ratings synthesised and laid out")
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 41))
    pool = heavy_rows(coo, n_rows, mix["pool_size"], mix["pool_min_ratings"],
                      gen)
    F = data.dense_rows(coo, n_rows, width, dev)
    pool_rows = F[pool.to(dev)].cpu()
    # The arena takes F over uncopied where the build offers it.
    hand = ({"hand_over": True}
            if "hand_over" in inspect.signature(build_state).parameters
            else {})
    state = build_state(F, capacity_extra=0, **hand)
    del F
    ctx.lap("arena built")

    n_bursts = data.count_requests(mix["rate_per_s"], ctx.seconds)
    warm = [("copy", mix["warm_k"], 0), ("fresh", mix["warm_k"], 0)]
    window = plan_bursts(n_bursts, mix, gen)
    n_fresh = 1 + sum(1 for kind, _, _ in window if kind == "fresh")
    fresh = fresh_rows(cfg, n_fresh, width, mix["fresh_raters"],
                       data.generator(dev, derive_seed(ctx.seed, 42)),
                       dev).cpu()
    probe_gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 43))
    step_cfg = dataclasses.replace(CONFIG, mode=cfg["mode"], **cfg["burst"])

    def payload(kind, k, p, fresh0):
        row = pool_rows[p] if kind == "copy" else fresh[fresh0 + p]
        return (kind, row.expand(k, -1).contiguous(),
                make_probes(probe_gen, k, step_cfg.c_probes, n_rows))

    loads = {"warm": [payload(kind, k, p, 0) for kind, k, p in warm],
             "window": [payload(kind, k, p, 1) for kind, k, p in window]}
    due = data.due_times(mix, n_bursts, ctx.seconds, torch.Generator()
                         .manual_seed(derive_seed(ctx.seed, 44)))
    st = {"state": state, "step": onboard_step, "cfg": step_cfg,
          "coo": coo, "loads": loads, "due": due, "n_base": n_rows,
          "width": width, "outs": []}
    for load in loads["warm"]:
        st["outs"].append(_burst(st, *load))
    ctx.lap("warm-up bursts")
    st["digest"] = _digest(state)
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        ctx.note(f"peak device memory through set-up "
                 f"{torch.cuda.max_memory_allocated(dev)} B")
    return st


def _burst(st, kind: str, R_new: torch.Tensor, probes: torch.Tensor
           ) -> dict:
    """One burst through the program, read back: its lists stay on the
    device, its stats come to the host."""
    state = st["state"]
    vals, idx, stats = st["step"](state, R_new, probes, st["cfg"])
    if state.ratings.is_cuda:
        torch.cuda.synchronize(state.ratings.device)
    return {"kind": kind, "R_new": R_new, "vals": vals, "idx": idx,
            "found": stats.found.cpu(), "twin": stats.twin_idx.cpu(),
            "overflowed": stats.overflowed.cpu()}


def _digest(state) -> tuple:
    """The base's active count and the bits of its four tensors."""
    return (state.n_active,) + tuple(
        reference_burst.bit_digest(t) for t in (state.ratings, state.norms,
                                                state.sim_vals,
                                                state.sim_idx))


def _counts(out: dict, n_base: int) -> dict:
    found, twin = out["found"], out["twin"]
    return {"rows": int(found.numel()),
            "base_twins": int((found & (twin < n_base)).sum()),
            "burst_twins": int((found & (twin >= n_base)).sum()),
            "fallbacks": int((~found).sum()),
            "overflows": int(out["overflowed"].sum())}


def window(ctx, st, tracer) -> dict:
    loads = st["loads"]["window"]
    bursts = openloop.run(st["due"], lambda i: _burst(st, *loads[i]), tracer,
                          "cfbench.onboard_step")
    requests, summary = [], []
    totals = dict.fromkeys(("rows", "base_twins", "burst_twins",
                            "fallbacks", "overflows"), 0)
    for i, b in enumerate(bursts):
        out = b.pop("result")
        st["outs"].append(out)
        c = _counts(out, st["n_base"])
        for key in totals:
            totals[key] += c[key]
        summary.append({**b, "kind": out["kind"], "k": c["rows"], **c})
        requests += [{**b, "result": {"status": "ok", "burst": i, "row": j,
                                      "twin": bool(out["found"][j])}}
                     for j in range(c["rows"])]
    ctx.note(openloop.lateness_note(bursts))
    ctx.note(openloop.queue_note(bursts, [(b["end"] - b["start"]) * 1e3
                                          for b in bursts]))
    ctx.note(f"bursts {len(bursts)}, rows {totals['rows']}: base twins "
             f"{totals['base_twins']}, burst twins {totals['burst_twins']}, "
             f"fallbacks {totals['fallbacks']}, overflows "
             f"{totals['overflows']}")
    return {"kind": "onboard", "requests": requests, "bursts": summary,
            "stats": totals, "arena": [st["n_base"], st["width"]],
            "attempted": len(bursts), "failed": 0}


def _collect(ctx, st) -> None:
    """Read what the program answered and the base after the window, then
    free its state and make the reference's base rows on the device."""
    dev = ctx.device
    state, n_base = st["state"], st["n_base"]
    outs = st["outs"]
    twins = sorted({t for o in outs for f, t in zip(o["found"].tolist(),
                                                    o["twin"].tolist())
                    if f and 0 <= t < n_base})
    copied = {}
    if twins:
        ids = torch.tensor(twins, device=dev)
        lists = reference_burst.by_id(state.sim_vals[ids],
                                      state.sim_idx[ids], n_base)
        copied = dict(zip(twins, lists))
    geometry = int(_digest(state) != st["digest"])
    st["state"] = state = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    F = data.dense_rows(st["coo"], n_base, st["width"], dev)
    st["judged"] = {"F": F, "copied": copied, "geometry": geometry}


def check(ctx, st, records, control: str | None = None) -> list[Check]:
    """Judge every burst after the window; with ``control`` (a precision),
    the reference's own lists at that precision stand in for the
    program's."""
    if "judged" not in st:
        _collect(ctx, st)
    j = st["judged"]
    e = reference_burst.judge(j["F"], st["outs"], j["copied"],
                              control=control)
    ctx.note(f"burst check: {e['bursts']} bursts, {e['rows']} rows")
    lim = ctx.mix["limits"]
    return [Check("sim_gap", e["gap"], lim["sim_gap"]),
            Check("list_id_rows", e["id_rows"], 0),
            Check("unsorted_rows", e["unsorted_rows"], 0),
            Check("twin_flag_errors", e["flags"], 0),
            Check("twin_copy_errors", e["copies"], 0),
            Check("geometry_errors", j["geometry"] + e["shape"], 0)]
