"""Traffic kind ``build``: closed-loop, back-to-back full similarity
builds through ``repro_torch.models.cf.build_step`` (the nightly
rebuild, the paper's O(n^2 m) baseline).

Set-up: the configuration's ratings on the device in the build's dtype,
and one build.  The window: builds one after another until ``seconds``
have passed; after each, ``sample_rows`` rows of its lists (a seeded
draw, new for every build) are copied aside.

Correct: every sampled row against the reference at the configuration's
stated precision (rows normalised in float32 and rounded to the build's
dtype, products summed exactly): each id once, ascending, each value
within the limit.
"""
from __future__ import annotations

import gc
import time

import torch

from cfbench import data, reference
from cfbench.bench import Check, derive_seed

def setup(ctx, tracer) -> dict:
    from repro_torch.models.cf import build_step
    cfg, dev = ctx.config, ctx.device
    R = data.synth_ratings(cfg, derive_seed(ctx.seed, 1), dev)
    Rb = R.to(getattr(torch, ctx.mix["dtype"]))
    del R
    ctx.lap("ratings synthesised")
    vals, idx = build_step(Rb)
    del vals, idx
    tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    gen = torch.Generator().manual_seed(derive_seed(ctx.seed, 31))
    return {"R": Rb, "gen": gen}


def window(ctx, st, tracer) -> dict:
    from repro_torch.models.cf import build_step
    R, dev, k = st["R"], ctx.device, ctx.mix["sample_rows"]
    n = R.shape[0]
    kept, times = [], []
    base = time.perf_counter()
    while True:
        now = time.perf_counter() - base
        tracer.tick(now)
        if now >= ctx.seconds:
            break
        rows = torch.randperm(n, generator=st["gen"])[:k].to(dev)
        with tracer.span("cfbench.build_step"):
            vals, idx = build_step(R)
        with tracer.span("cfbench.sample_rows"):
            kept.append((rows, vals[rows], idx[rows]))
            del vals, idx
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - base)
    tracer.stop()
    st["kept"] = kept
    per = [b - a for a, b in zip([0.0] + times[:-1], times)]
    ctx.note(f"builds {len(per)}: min {min(per):.4f} s, max {max(per):.4f} s")
    return {"kind": "build", "builds": len(times), "ends": times,
            "window_s": times[-1] if times else 0.0,
            "n": n, "m": R.shape[1],
            "attempted": len(times), "failed": 0}


def check(ctx, st, records, control: str | None = None) -> list[Check]:
    """Judge every sampled row; with ``control`` (a precision), the
    reference's own lists at that precision stand in for the build's."""
    R = st["R"]
    n = R.shape[0]
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    rows = torch.cat([r for r, _, _ in st["kept"]])
    vals = torch.cat([v for _, v, _ in st["kept"]])
    idx = torch.cat([i for _, _, i in st["kept"]])
    cols = torch.full_like(rows, n)
    e = reference.judge_lists(rows, R, cols, ctx.mix["dtype"], vals,
                              idx, control=control)
    ctx.note(f"build check: {e['rows']} sampled rows of "
             f"{records['builds']} builds")
    lim = ctx.mix["limits"]
    return [Check("sim_gap", e["gap"], lim["sim_gap"]),
            Check("list_id_rows", e["id_rows"], 0),
            Check("unsorted_rows", e["unsorted_rows"], 0)]
