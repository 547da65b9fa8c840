"""Quickstart on the PyTorch port: neighbourhood CF with TwinSearch
new-user onboarding, on one CUDA card (or the CPU with ``--device cpu``).

Builds a MovieLens-100k-scale system, onboards a burst of identical new
users (the paper's special case / kNN-attack scenario), and shows the
TwinSearch fast path against the traditional rebuild.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import time

from repro_torch.data import movielens_100k, plant_twins
from repro_torch.serving import CFServer, ServerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device

    print(f"== building MovieLens-scale CF system (943 users x 1682 films) "
          f"on {device}")
    R = movielens_100k(seed=0)
    t0 = time.perf_counter()
    srv = CFServer(R, ServerConfig(capacity_extra=32, c_probes=8),
                   device=device)
    print(f"   full similarity build: {time.perf_counter() - t0:.2f}s")

    print("== kNN-attack burst: 10 identical new users (>=8 ratings)")
    burst = plant_twins(R, 10, source_user=None, seed=7)
    for i in range(10):
        uid, info = srv.onboard_user(burst[i])      # the legacy protocol
        path = "TwinSearch copy" if info["twin_found"] else "full build"
        print(f"   user {uid}: {path:15s} {info['ms']:7.1f}ms")
    s = srv.stats.summary()
    print(f"   twin hits: {s['twin_hits']}/10, fallbacks {s['fallbacks']}, "
          f"p50 {s['onboard_p50_ms']:.1f}ms")

    print("== the copied lists serve recommendations immediately")
    recs = srv.recommend(943, n=5)           # first onboarded user
    print("   top-5 films for new user 943:",
          [f"#{i}({s:.2f})" for i, s in recs])

    print("== baseline comparison: same burst, traditional path only")
    srv2 = CFServer(R, ServerConfig(capacity_extra=32), device=device)
    for i in range(10):
        srv2.onboard_user(burst[i], use_twinsearch=False)
    med = lambda xs: sorted(xs)[len(xs) // 2]            # noqa: E731
    # steady-state medians (the first call on each path builds kernels)
    t_tw = med(list(srv.stats.onboard_ms)[1:])
    t_tr = med(list(srv2.stats.onboard_ms)[1:])
    print(f"   per-user p50: traditional {t_tr:.1f}ms vs twinsearch "
          f"{t_tw:.1f}ms ({t_tr / max(t_tw, 1e-9):.1f}x)")
    print("   (MovieLens is small — the gap grows with n·m; chip_smoke.py "
          "runs the Douban width)")


if __name__ == "__main__":
    main()
