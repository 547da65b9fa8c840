"""The kNN-attack scenario (Calandrino et al.) on the PyTorch port: an
attacker injects k identical fake profiles (>= 8 rated items) to surround
a target user.  The demo shows (a) the system-load angle — TwinSearch
makes onboarding the flood ~free instead of k full rebuilds — and (b) twin
detection as a *defence* signal (a burst of exact twins is anomalous).
One CUDA card, or ``--device cpu``.

Run:  PYTHONPATH=src python examples/knn_attack_demo_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import knn
from repro_torch.data import plant_twins, synth_ratings
from repro_torch.serving import CFServer, ServerConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device

    R = synth_ratings(0, 1500, 600, 60_000)
    srv = CFServer(R, ServerConfig(capacity_extra=64, c_probes=8),
                   device=device)

    print(f"== attacker injects k=30 identical fake users ({device})")
    attack = plant_twins(R, 30, source_user=None, seed=13)
    twin_flags = []
    for i in range(30):
        res = srv.onboard_user(attack[i])
        twin_flags.append(res.twin_found)

    s = srv.stats.summary()
    print(f"   onboarding cost: {s['fallbacks']} full build(s) + "
          f"{s['twin_hits']} list copies "
          f"(traditional: 30 full builds)")

    # Defence signal: consecutive exact-twin onboards
    streak = 0
    best = 0
    for f in twin_flags:
        streak = streak + 1 if f else 0
        best = max(best, streak)
    print(f"   longest exact-twin onboarding streak: {best} "
          f"(threshold-alarm material — organic traffic almost never "
          f"produces long exact-duplicate runs)")

    # The attack profile's neighbourhood is now all fakes (query the last
    # fake: its copied-and-patched list covers the whole burst):
    last = int(srv.state.n_active) - 1
    sims, nbrs = knn.top_k_neighbors(srv.state, last, 10)
    n_fake = int(np.sum(nbrs.cpu().numpy() >= 1500))
    print(f"   fake user #{last}'s top-10 neighbours: {n_fake}/10 are "
          f"fellow fakes (sim=1.0) — the mechanism the attack exploits")


if __name__ == "__main__":
    main()
