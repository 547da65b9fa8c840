"""``CFServer`` from a configuration file, and the onboarding traffic the
server-backed kinds share (the onboard cells' window, the read cell's
set-up).

The configuration's ``server`` and ``monitor`` groups map one to one onto
``repro_torch.serving.ServerConfig``; nothing else about the server is
decided here.
"""
from __future__ import annotations

import numpy as np
import torch

from cfbench import data
from cfbench.bench import derive_seed


def make_server(cfg: dict, R: torch.Tensor, device):
    from repro_torch.serving import (CFServer, LadderConfig, RotationConfig,
                                     ServerConfig, SnapshotConfig)
    from repro_torch.training.elastic import StragglerMonitor
    s = cfg["server"]
    return CFServer(R, ServerConfig(
        capacity_extra=s["capacity_extra"], c_probes=s["c_probes"],
        sim_tol=s["sim_tol"], seed=s["probe_seed"],
        rating_range=tuple(cfg["rating_range"]),
        snapshot=SnapshotConfig(every=s["snapshot_every"],
                                check_every=s["check_every"]),
        rotation=RotationConfig(headroom=s["rotation_headroom"],
                                budget_rows=s["rotation_budget_rows"]),
        ladder=LadderConfig(monitor=StragglerMonitor(**cfg["monitor"]))),
        device=device)


class Onboarding:
    """The onboard mix's requests: each a copy of one of ``pool_size``
    base users (a twin) or a fresh profile, in a seeded order with the
    same counts for every seed.  Payloads are host arrays, as a client
    sends them."""

    def __init__(self, cfg: dict, mix: dict, R: torch.Tensor, seed: int,
                 counts: dict, device):
        gen = data.generator(device, derive_seed(seed, 11))
        pool = data.twin_pool(R, mix["pool_size"], mix["pool_min_ratings"],
                              gen)
        self.plans = {}
        host = torch.Generator().manual_seed(derive_seed(seed, 12))
        n_fresh = 0
        for name, n in counts.items():
            self.plans[name] = self._plan(n, mix, host, n_fresh)
            n_fresh += sum(1 for k, _ in self.plans[name] if k == "fresh")
        fresh = data.fresh_profiles(cfg, n_fresh, gen, device)
        self.fresh = fresh.cpu().numpy()
        self.pool_rows = R[pool].cpu().numpy()

    @staticmethod
    def _plan(n: int, mix: dict, gen: torch.Generator, fresh0: int
              ) -> list[tuple[str, int]]:
        """``n`` requests: round(twin_share n) copies spread evenly over
        the pool, the rest fresh profiles numbered from ``fresh0``; the
        first is a copy and the second fresh when ``n`` >= 2, so a
        warm-up meets both paths."""
        n_copy = int(round(mix["twin_share"] * n))
        kinds = ([("copy", i % mix["pool_size"]) for i in range(n_copy)]
                 + [("fresh", fresh0 + j) for j in range(n - n_copy)])
        order = torch.randperm(n, generator=gen).tolist()
        out = [kinds[i] for i in order]
        for want, pos in (("copy", 0), ("fresh", 1)):
            if n > pos and out[pos][0] != want:
                j = next((j for j in range(pos + 1, n)
                          if out[j][0] == want), None)
                if j is not None:
                    out[pos], out[j] = out[j], out[pos]
        return out

    def payload(self, req: tuple[str, int]) -> np.ndarray:
        kind, i = req
        return self.pool_rows[i] if kind == "copy" else self.fresh[i]


def onboard_record(res, srv, cap_before: int) -> dict:
    """What one ``onboard_user`` result says, with the rotation it paid."""
    return {"status": res.status, "twin": bool(res.twin_found),
            "latency_ms": float(res.latency_ms), "rotated": bool(res.rotated),
            "rung": res.rung, "user_id": int(res.user_id),
            "rotation_ms": (float(srv.stats.rotation_ms[-1]) if res.rotated
                            and srv.stats.rotation_ms else None),
            "cap_before": cap_before, "cap_after": srv.state.capacity}


def expected_geometry(n0: int, extra: int, appended: int) -> tuple[int, int]:
    """(n_base, capacity) after ``appended`` users join an arena of ``n0``
    base rows and ``extra`` free slots whose synchronous rotation, at
    headroom 1, compacts the full write region and opens ``extra`` new
    slots: the configuration's stated growth, worked out apart from the
    server."""
    rotations = (appended - 1) // extra if appended > 0 else 0
    return n0 + rotations * extra, n0 + (rotations + 1) * extra
