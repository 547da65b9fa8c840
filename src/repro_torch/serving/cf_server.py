"""Neighbourhood-CF recommendation server with the paper's TwinSearch
new-user onboarding fast path (PyTorch port of
``repro.serving.cf_server``).

Request surface:

  * ``onboard_user(ratings)``   — TwinSearch -> copy, or traditional build
                                  fallback; returns a typed
                                  ``OnboardResult``.
  * ``onboard_batch(batch)``    — a sequence of onboards.
  * ``recommend(user, n)``      — top-n unseen items via kNN scores.
  * ``predict(user, item)``     — kNN weighted-average rating.
  * ``recommend_batch(users)``  — B recommendations: per-row guard
                                  validation, twin-query dedup, one scoring
                                  launch for the unique rows.
  * ``predict_batch(users, items)`` — B predictions, same contract.

The server runs on the card by default (``device="cuda"``) and raises if
there is none; pass ``device="cpu"`` to run the plain PyTorch versions of
the kernels.

Resilience contract, as in the reference: no public entry point raises to
the caller.  Malformed payloads are refused by ``serving/guard.py`` and
quarantined; a full arena triggers a synchronous **arena rotation**
(``core/rotation.py``); onboard latencies drive the degradation ladder
twinsearch -> traditional -> shed through a ``StragglerMonitor``; the
onboard call runs under retry with backoff; an in-memory snapshot plus the
``arena_healthy`` check every ``check_every`` onboards rolls a poisoned
arena back.  Reads are never refused: an invalid row is quarantined and
answers empty/0.0, and the shed rung serves reads at ``k // 4``.

Differences from the reference:

  * The arena is written in place (``core/types.py``), so the snapshot is
    a clone and rollback restores from a clone of it.
  * Probes come from a CPU ``torch.Generator`` seeded with
    ``config.seed`` (``_draw_probes``), not from a ``jax.random`` key
    chain; the generator state is part of the snapshot.
  * Query batches are not padded to power-of-two buckets: eager PyTorch
    has nothing to recompile.
  * Not ported yet (each raises ``NotImplementedError`` naming its
    ROADMAP item): ``wal.dir``, ``snapshot.dir``, ``replication``,
    ``rotation.budget_rows > 0``, ``add_rating``, ``step_maintenance``,
    ``recover``.  The degraded-replica rung therefore never engages.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import baseline as base_lib
from repro_torch.core import knn
from repro_torch.core import twinsearch as ts
from repro_torch.core.rotation import rotate_arena
from repro_torch.core.types import (CFState, clone_state, require_device,
                                    set0_cap)
from repro_torch.kernels.knn_score.ops import knn_recommend_topn
from repro_torch.kernels.verify_rows.ops import arena_healthy
from repro_torch.serving import guard
from repro_torch.serving.config import ServerConfig
from repro_torch.serving.dedup import dedup_rows
from repro_torch.training.elastic import Action, StragglerMonitor

log = logging.getLogger(__name__)

# Degradation ladder levels (ascending = more degraded).
LEVEL_TWINSEARCH = 0
LEVEL_TRADITIONAL = 1
LEVEL_DEGRADED = 2          # replica redundancy lost (replication not ported)
LEVEL_SHED = 3
LEVEL_NAMES = {LEVEL_TWINSEARCH: "twinsearch",
               LEVEL_TRADITIONAL: "traditional",
               LEVEL_DEGRADED: "degraded",
               LEVEL_SHED: "shed"}

# Shed-rung query degradation: reads are served with k_neighbors // this
# (floor 1) instead of being refused.
SHED_QUERY_K_DIV = 4


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md Queue 1, "
        f"{item})")


@dataclass
class ServerStats:
    onboarded: int = 0
    twin_hits: int = 0
    fallbacks: int = 0
    overflows: int = 0
    rejected: int = 0
    shed: int = 0
    retries: int = 0
    errors: int = 0
    rotations: int = 0
    snapshots: int = 0
    rollbacks: int = 0
    degradations: int = 0
    recoveries: int = 0
    queries: int = 0            # query rows served (valid rows only)
    query_batches: int = 0      # recommend_batch / predict_batch calls
    query_unique: int = 0       # rows actually scored after twin dedup
    query_degraded: int = 0     # rows served at shed-reduced k_neighbors
    latency_window: int = 1024
    onboard_ms: deque = field(init=False)
    rotation_ms: deque = field(init=False)
    query_ms: deque = field(init=False)
    query_dedup_savings: deque = field(init=False)

    def __post_init__(self) -> None:
        # Fixed-size ring buffers: sustained traffic must not grow host
        # memory; summary() percentiles are over the trailing window.
        self.onboard_ms = deque(maxlen=self.latency_window)
        self.rotation_ms = deque(maxlen=64)
        self.query_ms = deque(maxlen=self.latency_window)
        self.query_dedup_savings = deque(maxlen=self.latency_window)

    def summary(self) -> dict:
        ms = sorted(self.onboard_ms) or [0.0]
        rot = sorted(self.rotation_ms) or [0.0]
        qms = sorted(self.query_ms) or [0.0]
        return {
            "onboarded": self.onboarded,
            "twin_hits": self.twin_hits,
            "fallbacks": self.fallbacks,
            "overflows": self.overflows,
            "rejected": self.rejected,
            "shed": self.shed,
            "retries": self.retries,
            "errors": self.errors,
            "rotations": self.rotations,
            "snapshots": self.snapshots,
            "rollbacks": self.rollbacks,
            "degradations": self.degradations,
            "recoveries": self.recoveries,
            "onboard_p50_ms": ms[len(ms) // 2],
            "onboard_p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
            "rotation_p50_ms": rot[len(rot) // 2],
            "rotation_max_ms": rot[-1],
            "queries": self.queries,
            "query_batches": self.query_batches,
            "query_unique": self.query_unique,
            "query_degraded": self.query_degraded,
            "query_p50_ms": qms[len(qms) // 2],
            "query_p99_ms": qms[min(len(qms) - 1, int(len(qms) * 0.99))],
            "query_dedup_savings": (1.0 - self.query_unique
                                    / max(self.queries, 1)),
        }


@dataclass(frozen=True)
class OnboardResult:
    """Typed outcome of ``onboard_user`` / ``onboard_batch`` (the
    reference's legacy ``(uid, info)`` unpacking is not carried over)."""
    user_id: int = -1
    status: str = "ok"        # ok|rejected|shed|error|rolled_back
    rung: str = "twinsearch"  # ladder level the request was served at
    latency_ms: float = 0.0
    rotated: bool = False     # this request triggered a rotation
    seq: int = -1             # mutation sequence number (-1: none)
    twin_found: bool = False
    reason: str | None = None
    detail: str | None = None
    retry_after_s: float | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


class CFServer:
    def __init__(self, ratings, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda"):
        """Build the arena from ``ratings`` ((n, m), numpy or tensor, 0 =
        unrated) on ``device``.  Raises if ``device`` is CUDA and no card
        is present: the server never slides onto the CPU by itself."""
        config = config if config is not None else ServerConfig()
        if config.wal.dir is not None:
            raise _not_ported("the write-ahead log (wal.dir)", "items 8-9")
        if config.snapshot.dir is not None:
            raise _not_ported("durable checkpoints (snapshot.dir)",
                              "items 8-9")
        if config.replication is not None:
            raise _not_ported("replication", "item 10")
        if config.rotation.budget_rows > 0:
            raise _not_ported("incremental rotation (rotation.budget_rows "
                              "> 0, RotationPlan)", "item 7")
        self.device = require_device(device, "CFServer")
        self.config = config

        self.n_base = int(ratings.shape[0])
        self.k_cap = int(config.capacity_extra)
        self.c = config.c_probes
        self.tol = config.sim_tol
        self.rating_range = (float(config.rating_range[0]),
                             float(config.rating_range[1]))
        self.rotate_headroom = float(config.rotation.headroom)
        self.state: CFState = knn.build_state(
            torch.as_tensor(ratings).to(self.device),
            capacity_extra=config.capacity_extra, measure=config.measure)
        self.s_max = set0_cap(self.n_base)
        self._gen = torch.Generator().manual_seed(config.seed)
        self.stats = ServerStats(latency_window=config.latency_window)
        self.quarantine = guard.Quarantine(
            capacity=config.quarantine_capacity)

        # Degradation ladder + retry machinery.  The monitor's clock is the
        # server's time source for shed cooldowns too.
        self.retry = config.ladder.retry or guard.RetryPolicy()
        self.monitor = config.ladder.monitor or StragglerMonitor(
            window=64, straggler_ratio=4.0, hang_timeout_s=30.0,
            consecutive_to_shrink=3)
        self._clock = self.monitor.clock
        self.level = LEVEL_TWINSEARCH
        self.recover_after = int(config.ladder.recover_after)
        self.shed_cooldown_s = float(config.ladder.shed_cooldown_s)
        self._healthy_streak = 0
        self._shed_until = 0.0

        self.snapshot_every = int(config.snapshot.every)
        self.check_every = int(config.snapshot.check_every)
        self._since_snapshot = 0
        self._since_check = 0
        self._seq = 0               # mutation counter (OnboardResult.seq)
        self._snapshot = None
        self._take_snapshot()       # the construction-time good state

    @classmethod
    def recover(cls, *args, **kwargs) -> "CFServer":
        raise _not_ported("CFServer.recover", "item 9")

    # -- internal machinery -------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _retarget(self) -> None:
        """Derived geometry after a rotation or rollback."""
        self.k_cap = self.state.capacity - self.n_base
        self.s_max = set0_cap(self.n_base)

    def _draw_probes(self) -> torch.Tensor:
        """(c,) random probe ids over the base population, from the
        server's CPU generator (the same draws on every device)."""
        return torch.randint(0, self.n_base, (self.c,), generator=self._gen)

    def _log(self) -> int:
        self._seq += 1
        return self._seq

    def _reject(self, kind: str, reason: str, payload=None,
                detail: str = "") -> dict:
        self.stats.rejected += 1
        self.quarantine.record(kind, reason, payload, detail)
        return {"status": "rejected", "reason": reason}

    # -- degradation ladder -------------------------------------------------

    def _set_level(self, level: int) -> None:
        if level == self.level:
            return
        if level > self.level:
            self.stats.degradations += 1
            log.warning("degrading %s -> %s", LEVEL_NAMES[self.level],
                        LEVEL_NAMES[level])
        else:
            self.stats.recoveries += 1
            log.info("recovering %s -> %s", LEVEL_NAMES[self.level],
                     LEVEL_NAMES[level])
        self.level = level
        self._healthy_streak = 0
        if level == LEVEL_SHED:
            self._shed_until = self._clock() + self.shed_cooldown_s

    def _step_down(self) -> None:
        if self.level == LEVEL_SHED:
            self._set_level(LEVEL_TRADITIONAL)
        else:
            self._set_level(max(LEVEL_TWINSEARCH, self.level - 1))

    def _apply_monitor(self, action: Action) -> None:
        if action is Action.ABORT:
            # A hang-scale latency: shed immediately, don't walk the ladder.
            self._set_level(LEVEL_SHED)
        elif action is Action.CHECKPOINT_AND_SHRINK:
            self._set_level(LEVEL_TRADITIONAL
                            if self.level == LEVEL_TWINSEARCH
                            else LEVEL_SHED)
        else:
            self._healthy_streak += 1
            if (self.level > LEVEL_TWINSEARCH
                    and self._healthy_streak >= self.recover_after):
                self._step_down()

    # -- rotation -----------------------------------------------------------

    def _rotate(self) -> None:
        """Grow the arena: compact the write region into a new base (see
        ``core/rotation.py``)."""
        old_capacity = self.state.capacity
        t0 = time.perf_counter()
        self.state = rotate_arena(self.state, n_base=self.n_base,
                                  extra=self.k_cap,
                                  headroom=self.rotate_headroom)
        self._sync()
        dt_ms = (time.perf_counter() - t0) * 1e3
        self.n_base = self.state.n_active
        self._retarget()
        self.stats.rotations += 1
        self.stats.rotation_ms.append(dt_ms)
        log.info("arena rotated: capacity %d -> %d (n_base=%d, %.1fms)",
                 old_capacity, self.state.capacity, self.n_base, dt_ms)

    # -- snapshot / rollback ------------------------------------------------

    def _take_snapshot(self) -> None:
        # Drop the old snapshot first: two full clones need not coexist.
        self._snapshot = None
        self._snapshot = (clone_state(self.state), self.n_base,
                          self._gen.get_state(), self._seq)
        self.stats.snapshots += 1
        self._since_snapshot = 0

    def _rollback(self) -> None:
        snap, n_base, gen_state, seq = self._snapshot
        # The live state is written in place: restore from a clone so the
        # snapshot stays good for a later rollback.
        self.state = clone_state(snap)
        self.n_base = n_base
        self._gen.set_state(gen_state)
        self._seq = seq
        self._retarget()
        self.stats.rollbacks += 1
        self._since_check = 0
        self._since_snapshot = 0
        log.error("arena invariant violated; rolled back to last good "
                  "snapshot (n_active=%d)", snap.n_active)

    def _healthy(self) -> bool:
        st = self.state
        return bool(arena_healthy(st.sim_vals, st.ratings, st.norms,
                                  st.n_active))

    def _check_and_snapshot(self) -> bool:
        """Periodic poison detection + snapshot cadence.  Returns False if
        the state failed the invariant and was rolled back."""
        self._since_check += 1
        self._since_snapshot += 1
        if self._since_check >= self.check_every:
            self._since_check = 0
            if not self._healthy():
                self._rollback()
                return False
        if self._since_snapshot >= self.snapshot_every:
            # Never snapshot unverified state.
            if self._healthy():
                self._take_snapshot()
        return True

    # -- onboarding ---------------------------------------------------------

    def _commit_onboard(self, new_state: CFState, found: bool,
                        overflowed: bool) -> None:
        self.state = new_state
        self.stats.onboarded += 1
        self.stats.twin_hits += found
        self.stats.fallbacks += not found
        self.stats.overflows += overflowed

    def onboard_user(self, ratings: np.ndarray, *,
                     use_twinsearch: bool = True) -> OnboardResult:
        reason = guard.validate_ratings_vector(
            ratings, n_items=self.state.n_items,
            rating_range=self.rating_range)
        if reason is not None:
            self._reject("onboard", reason, ratings)
            return OnboardResult(status="rejected", reason=reason,
                                 rung=LEVEL_NAMES[self.level])

        if self.level == LEVEL_SHED:
            if self._clock() < self._shed_until:
                self.stats.shed += 1
                return OnboardResult(
                    status="shed", rung=LEVEL_NAMES[self.level],
                    retry_after_s=self._shed_until - self._clock())
            # Cooldown expired: probe the cheaper build path again.
            self._set_level(LEVEL_TRADITIONAL)

        rotated = False
        if self.state.n_active >= self.state.capacity:
            rotated = True
            self._log()
            self._rotate()

        r0 = torch.as_tensor(np.asarray(ratings, dtype=np.float32),
                             device=self.device)
        use_twin = use_twinsearch and self.level == LEVEL_TWINSEARCH
        if use_twin:
            probes = self._draw_probes()

            def run():
                new_state, res = ts.onboard_twinsearch(
                    self.state, r0, probes, s_max=self.s_max,
                    n_base=self.n_base, k_cap=self.k_cap, tol=self.tol)
                found, ovf = bool(res.found), bool(res.overflowed)
                self._sync()
                return new_state, found, ovf
        else:
            def run():
                new_state = base_lib.onboard_traditional(self.state, r0)
                self._sync()
                return new_state, False, False

        seq = self._log()
        self.monitor.step_started()
        t0 = time.perf_counter()
        try:
            (new_state, found, overflowed), retries = guard.call_with_retry(
                run, self.retry)
        except Exception as e:          # noqa: BLE001 — contract: no raise
            self.monitor.step_finished()
            self.stats.errors += 1
            self._log()                 # the reference logs an abort record
            self.quarantine.record("onboard", guard.R_ERROR, ratings,
                                   detail=repr(e))
            log.error("onboard failed after retries: %r", e)
            return OnboardResult(status="error", reason=guard.R_ERROR,
                                 rung=LEVEL_NAMES[self.level],
                                 rotated=rotated, seq=seq, detail=repr(e))
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._apply_monitor(self.monitor.step_finished())

        self.stats.retries += retries
        self._commit_onboard(new_state, found, overflowed)
        self.stats.onboard_ms.append(dt_ms)

        if not self._check_and_snapshot():
            return OnboardResult(status="rolled_back", latency_ms=dt_ms,
                                 rung=LEVEL_NAMES[self.level],
                                 rotated=rotated, seq=seq)
        return OnboardResult(user_id=self.state.n_active - 1, status="ok",
                             twin_found=found, latency_ms=dt_ms,
                             rung=LEVEL_NAMES[self.level], rotated=rotated,
                             seq=seq)

    def onboard_batch(self, ratings_batch, *,
                      use_twinsearch: bool = True) -> list[OnboardResult]:
        """Onboard a sequence of users; per-user ``OnboardResult``s."""
        return [self.onboard_user(r, use_twinsearch=use_twinsearch)
                for r in ratings_batch]

    # -- queries ------------------------------------------------------------

    def _query_k(self, k_neighbors: int) -> int:
        """The shed rung serves reads at a reduced neighbour count instead
        of refusing them."""
        if self.level == LEVEL_SHED:
            return max(1, int(k_neighbors) // SHED_QUERY_K_DIV)
        return int(k_neighbors)

    def _note_query_batch(self, n_valid: int, n_unique: int, savings: float,
                          dt_ms: float, degraded: bool) -> None:
        self.stats.query_batches += 1
        self.stats.queries += n_valid
        self.stats.query_unique += n_unique
        self.stats.query_ms.append(dt_ms)
        self.stats.query_dedup_savings.append(savings)
        if degraded:
            self.stats.query_degraded += n_valid

    def recommend_batch(self, users, n: int = 10, k_neighbors: int = 20
                        ) -> list[list[tuple[int, float]]]:
        """Top-``n`` recommendations for a batch of users.  An invalid user
        id is quarantined and its slot answers ``[]``.  Rows whose (top-k
        sims, neighbour ids, own ratings) keys are bitwise identical are
        scored once and fanned out."""
        users = list(users)
        results: list[list[tuple[int, float]]] = [[] for _ in users]
        valid = [i for i, u in enumerate(users)
                 if not (guard.validate_user_id(u, self.state.n_active)
                         and self._reject("recommend", guard.R_USER_ID, u))]
        if not valid:
            return results
        k_eff = self._query_k(k_neighbors)
        t0 = time.perf_counter()

        uvec = torch.as_tensor([int(users[i]) for i in valid],
                               device=self.device)
        sims, nbrs = knn.top_k_neighbors_batch(self.state, uvec, k_eff)
        nbrs = nbrs.to(torch.int32)
        rows = self.state.ratings[uvec]
        # Twin dedup: the scoring kernel is a deterministic function of
        # exactly (sims, nbrs, own row), so equal keys share scores.
        keys = np.concatenate([sims.cpu().numpy().view(np.uint32),
                               nbrs.cpu().numpy().view(np.uint32),
                               rows.cpu().numpy().view(np.uint32)], axis=1)
        plan = dedup_rows(keys)
        sel = torch.as_tensor(plan.unique_rows, device=self.device)
        scores, items = knn_recommend_topn(
            self.state.ratings, torch.clamp_min(sims[sel], 0.0), nbrs[sel],
            uvec[sel], n)
        scores, items = scores.cpu().numpy(), items.cpu().numpy()

        dt_ms = (time.perf_counter() - t0) * 1e3
        for pos, i in enumerate(valid):
            u = int(plan.scatter[pos])
            results[i] = [(int(it), float(s))
                          for s, it in zip(scores[u], items[u])]
        self._note_query_batch(len(valid), plan.n_unique, plan.savings,
                               dt_ms, degraded=k_eff != int(k_neighbors))
        return results

    def predict_batch(self, users, items, k: int = 20) -> list[float]:
        """kNN rating predictions for B (user, item) pairs; invalid rows
        are quarantined and answer 0.0.  Twin dedup keys on (top-k sims,
        neighbour ids, item)."""
        users, items = list(users), list(items)
        if len(users) != len(items):
            raise ValueError(f"{len(users)} users but {len(items)} items")
        results = [0.0] * len(users)
        valid = []
        for i, (u, it) in enumerate(zip(users, items)):
            if guard.validate_user_id(u, self.state.n_active):
                self._reject("predict", guard.R_USER_ID, u)
            elif guard.validate_item_id(it, self.state.n_items):
                self._reject("predict", guard.R_ITEM_ID, it)
            else:
                valid.append(i)
        if not valid:
            return results
        k_eff = self._query_k(k)
        t0 = time.perf_counter()

        uvec = torch.as_tensor([int(users[i]) for i in valid],
                               device=self.device)
        ivec = np.asarray([int(items[i]) for i in valid], np.int32)
        sims, nbrs = knn.top_k_neighbors_batch(self.state, uvec, k_eff)
        nbrs = nbrs.to(torch.int32)
        keys = np.concatenate([sims.cpu().numpy().view(np.uint32),
                               nbrs.cpu().numpy().view(np.uint32),
                               ivec.reshape(-1, 1).view(np.uint32)], axis=1)
        plan = dedup_rows(keys)
        sel = torch.as_tensor(plan.unique_rows, device=self.device)
        preds = knn.predict_from_neighbors(
            self.state, sims[sel], nbrs[sel].long(),
            torch.as_tensor(ivec, device=self.device)[sel]).cpu().numpy()

        dt_ms = (time.perf_counter() - t0) * 1e3
        for pos, i in enumerate(valid):
            results[i] = float(preds[int(plan.scatter[pos])])
        self._note_query_batch(len(valid), plan.n_unique, plan.savings,
                               dt_ms, degraded=k_eff != int(k))
        return results

    def recommend(self, user: int, n: int = 10,
                  k_neighbors: int = 20) -> list[tuple[int, float]]:
        """B=1 wrapper over ``recommend_batch``."""
        return self.recommend_batch([user], n=n, k_neighbors=k_neighbors)[0]

    def predict(self, user: int, item: int, k: int = 20) -> float:
        """B=1 wrapper over ``predict_batch``."""
        return self.predict_batch([user], [item], k=k)[0]

    # -- not ported yet -----------------------------------------------------

    def add_rating(self, user: int, item: int, rating: float) -> bool:
        raise _not_ported("CFServer.add_rating (core/update.py)", "item 6")

    def step_maintenance(self, budget_rows: int | None = None) -> dict:
        raise _not_ported("CFServer.step_maintenance (RotationPlan)",
                          "item 7")
