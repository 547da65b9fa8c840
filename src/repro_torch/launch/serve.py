"""Serving launcher of the port: the CF recommendation service (the paper's
system) or an LM decode service, on one CUDA card, or on the CPU when
asked.

  python -m repro_torch.launch.serve --service cf --users 2000 --items 800
  python -m repro_torch.launch.serve --service lm --arch gemma3-1b --n-new 16
  python -m repro_torch.launch.serve --service cf --device cpu

The LM service serves the architecture's family structure at the
reference's tiny widths (2 layers, d_model 128) from seeded random
weights: a batch of 5 prompts, 2 distinct, deduplicated before prefill.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import numpy as np

log = logging.getLogger("repro_torch.launch.serve")


def serve_cf(args):
    """Boot a CF server on synthetic ratings, onboard 8 planted twins of
    user 3, log each onboard and the stats; returns the server."""
    from repro_torch.data import plant_twins, synth_ratings
    from repro_torch.serving import CFServer, ServerConfig
    R = synth_ratings(0, args.users, args.items, args.users * 45)
    srv = CFServer(R, ServerConfig(capacity_extra=args.capacity,
                                   c_probes=args.probes),
                   device=args.device)
    log.info("CF service up on %s: %d users, %d items", args.device,
             args.users, args.items)
    burst = plant_twins(R, 8, source_user=3)
    for i in range(8):
        res = srv.onboard_user(burst[i])
        log.info("onboard %d twin=%s %.1fms", res.user_id, res.twin_found,
                 res.latency_ms)
    log.info("stats: %s", srv.stats.summary())
    return srv


def serve_lm(args):
    """Serve the tiny ``--arch`` LM (the reference's shrink of its config)
    on 5 prompts of 32 tokens, 2 distinct; logs the dedup savings and
    returns (completions, info)."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.core.types import require_device
    from repro_torch.models import transformer as lm
    from repro_torch.serving import LMServer
    spec = get_arch(args.arch)
    if spec.family != "lm":
        sys.exit(f"repro_torch.launch.serve: {args.arch} is a {spec.family} "
                 "architecture, not an LM; --service lm serves the lm family")
    device = require_device(args.device, "repro_torch.launch.serve")
    cfg = dataclasses.replace(spec.config, n_layers=2, d_model=128,
                              n_heads=4, n_kv_heads=1, head_dim=32,
                              d_ff=256, vocab_size=1024,
                              window=(64 if spec.config.window else None))
    params = lm.init_params(torch.Generator(device).manual_seed(0), cfg)
    srv = LMServer(params, cfg, max_len=128)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    batch = prompts[[0, 1, 0, 1, 0]]
    out, info = srv.generate(batch, n_new=args.n_new)
    log.info("generated %s on %s; dedup savings %.0f%% (prefilled %d/%d "
             "rows)", out.shape, device, 100 * info["dedup_savings"],
             info["prefill_rows"], info["batch"])
    return out, info


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--service", choices=["cf", "lm"], default="cf")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=800)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--probes", type=int, default=8)
    ap.add_argument("--arch", default="gemma3-1b",
                    help="the LM architecture (--service lm)")
    ap.add_argument("--n-new", type=int, default=8,
                    help="tokens to generate (--service lm)")
    return ap


def main(argv: list[str] | None = None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return (serve_cf if args.service == "cf" else serve_lm)(args)


if __name__ == "__main__":
    main()
