"""Serving scenario on the PyTorch port: a live CF recommendation service
handling a mixed request stream — onboarding (with duplicate-heavy
traffic), rating updates (incremental similarity maintenance), and
recommendation queries — on one CUDA card (or ``--device cpu``).

Run:  PYTHONPATH=src python examples/serve_recs_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.data import synth_ratings
from repro_torch.serving import CFServer, RotationConfig, ServerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device

    rng = np.random.default_rng(0)
    R = synth_ratings(0, 2000, 800, 90_000)
    print(f"== boot: 2000-user, 800-item system on {device}")
    srv = CFServer(R, ServerConfig(capacity_extra=64, c_probes=8,
                                   rotation=RotationConfig(budget_rows=256)),
                   device=device)

    print("== mixed request stream (200 requests)")
    t0 = time.perf_counter()
    n_q = n_u = 0
    onboard_pool = [None, 17, 17, None, 42]      # duplicate-heavy
    for i in range(200):
        kind = rng.random()
        if kind < 0.1 and srv.stats.onboarded < 60:
            src = onboard_pool[srv.stats.onboarded % len(onboard_pool)]
            row = (R[src] if src is not None else
                   synth_ratings(100 + i, 1, 800, 40)[0])
            res = srv.onboard_user(row)
            assert res.ok and res.rung == "twinsearch"
        elif kind < 0.3:
            srv.add_rating(int(rng.integers(0, 2000)),
                           int(rng.integers(0, 800)),
                           float(rng.integers(1, 6)))
            n_u += 1
        else:
            srv.recommend(int(rng.integers(0, 2000)), n=10)
            n_q += 1
    dt = time.perf_counter() - t0
    s = srv.stats.summary()
    print(f"   {n_q} queries, {n_u} rating updates, "
          f"{s['onboarded']} onboards in {dt:.2f}s")
    print(f"   onboarding: {s['twin_hits']} twin hits / "
          f"{s['fallbacks']} full builds "
          f"(p50 {s['onboard_p50_ms']:.1f}ms, "
          f"p99 {s['onboard_p99_ms']:.1f}ms)")
    hit_rate = s["twin_hits"] / max(s["onboarded"], 1)
    print(f"   twin-hit rate {hit_rate:.0%} — duplicate-heavy onboarding "
          f"traffic is the paper's regime")


if __name__ == "__main__":
    main()
