"""Serving launcher of the port: the CF recommendation service (the paper's
system) on one CUDA card, or on the CPU when asked.

  python -m repro_torch.launch.serve --service cf --users 2000 --items 800
  python -m repro_torch.launch.serve --service cf --device cpu

The LM decode service (``--service lm``) waits for the port's LM server
and exits with a message until then.
"""
from __future__ import annotations

import argparse
import logging
import sys

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


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--service", choices=["cf", "lm"], default="cf")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--users", type=int, default=2000)
    ap.add_argument("--items", type=int, default=800)
    ap.add_argument("--capacity", type=int, default=64)
    ap.add_argument("--probes", type=int, default=8)
    return ap


def main(argv: list[str] | None = None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.service == "lm":
        sys.exit("repro_torch.launch.serve: --service lm needs the LM "
                 "server, which the port does not have yet; use "
                 "--service cf")
    return serve_cf(args)


if __name__ == "__main__":
    main()
