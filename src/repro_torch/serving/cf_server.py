"""Neighbourhood-CF recommendation server with the paper's TwinSearch
new-user onboarding fast path (PyTorch port of
``repro.serving.cf_server``).

Request surface:

  * ``onboard_user(ratings)``   — TwinSearch -> copy, or traditional build
                                  fallback; returns a typed
                                  ``OnboardResult``.
  * ``onboard_batch(batch)``    — a sequence of onboards under one WAL
                                  group commit (one fsync per batch).
  * ``recommend(user, n)``      — top-n unseen items via kNN scores.
  * ``predict(user, item)``     — kNN weighted-average rating.
  * ``recommend_batch(users)``  — B recommendations: per-row guard
                                  validation, twin-query dedup, one scoring
                                  launch for the unique rows.
  * ``predict_batch(users, items)`` — B predictions, same contract.
  * ``add_rating(user, item, r)``— incremental (Papagelis-style) update of
                                  the affected similarity row.
  * ``step_maintenance()``      — drain a slice of any pending incremental
                                  rotation during quiet periods.

The server runs on the card by default (``device="cuda"``) and raises if
there is none; pass ``device="cpu"`` to run the plain PyTorch versions of
the kernels.

Resilience contract, as in the reference: no public entry point raises to
the caller.  Malformed payloads are refused by ``serving/guard.py`` and
quarantined; a full arena triggers an **arena rotation**
(``core/rotation.py``); onboard latencies drive the degradation ladder
twinsearch -> traditional -> shed through a ``StragglerMonitor``, and the
``degraded`` rung (the traditional path) is entered when replica
redundancy drops and held until re-replication restores it; the onboard
call runs under retry with backoff (a call that still fails is quarantined
and its WAL record aborted); an in-memory snapshot plus the
``arena_healthy`` check every ``check_every`` onboards rolls a poisoned
arena back.  Reads are never refused: an invalid row is quarantined and
answers empty/0.0, and the shed rung serves reads at ``k // 4``.

With ``replication=ReplicationConfig(...)`` the arena's row shards are
mirrored r-way on the host (``distributed/replication.py``).  A poisoned
primary row (a bit-flip, a lost shard) is healed from a surviving replica
before any rollback — pure data movement — and checked for before every
read batch; a lost replica is rebuilt from survivors a budget of rows per
request.  Rollback to the last good snapshot remains the backstop when no
replica survives.

With ``RotationConfig.budget_rows > 0`` rotation is *incremental*: a
``RotationPlan`` starts when free write slots fall to ``reserve_slots`` and
merges at most ``budget_rows`` base rows per onboard/tick (plus retry
backoff waits and shed backpressure windows), while new users keep landing
past the frozen boundary; the final swap is bit-identical to the
synchronous rotation of the live state and is the only part a request
waits for (``ServerStats.rotation_pause_ms``).  The swap is WAL-logged as
``rotate_commit``, so recovery replays it through ``rotate_arena_frozen``.

Durability contract, as in the reference: every mutating op is appended to
the **write-ahead log** (``serving/wal.py``, ``wal.dir``) *before* it is
applied; ``CFServer.recover(...)`` replays the log on top of the newest
durable checkpoint (``training/checkpoint.py``, ``snapshot.dir``) and
lands bit-identical to the pre-crash arena.  The log truncates at each
durable snapshot and rewinds on rollback.  The WAL and checkpoint formats
are the reference's, so either package recovers from the other's files.

Differences from the reference:

  * The arena is written in place (``core/types.py``), so the snapshot is
    a clone and rollback restores from a clone of it; ``add_rating``
    writes its row and the dots cache in place (``core/update.py``).
  * Before an ``add_rating``, the dots cache's rows of users onboarded
    since it was built are refreshed (``update.refresh_rows``); the
    reference leaves them at 0 and scores those users with similarities
    near 1e11 (ROADMAP Queue 3).  Checkpoints are fsynced before the WAL
    is truncated through them (``training/checkpoint.py``).
  * Probes come from a CPU ``torch.Generator`` seeded with
    ``config.seed`` (``_draw_probes``), not from a ``jax.random`` key
    chain; the generator state is part of the snapshot, and of a durable
    checkpoint under its own ``extra`` key (``GENERATOR_KEY``; the
    reference's ``"key"`` is its JAX key, ignored here).  Replaying a
    twin-search onboard draws (and drops) one set of probes so the
    generator advances as it did live; the recorded probes are the ones
    used.
  * WAL replay runs record by record; ``wal.replay_batch`` is accepted and
    has no effect (eager PyTorch has no scan to batch, and the reference
    guarantees the same state either way).  Recovery restores the newest
    checkpoint without building the arena from ``ratings`` first; the
    build runs only when there is no checkpoint.
  * Query batches are not padded to power-of-two buckets: eager PyTorch
    has nothing to recompile.
  * ``ServerStats`` also times the write path: WAL appends, whole
    ``add_rating`` calls (which return once the update is on the arena),
    dots-cache builds, maintenance-tick plan steps, durable checkpoint
    saves, ``recover``'s restore and replay, and full replica resets.
  * A replica repair writes the bad rows back in place, after checking
    that every one of them has a surviving replica; the reference copies
    the whole arena through the host and builds a new state.
  * The callables that compute similarities are instance attributes
    (``_onboard_trad``, ``_init_cache``, ``_add`` and ``_refresh_cache``,
    beside the ``_onboard`` method), so the fault harness can forbid them
    (``testing.faults.forbid_similarity_kernels``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import math
import warnings
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import baseline as base_lib
from repro_torch.core import knn
from repro_torch.core import twinsearch as ts
from repro_torch.core import update as upd_lib
from repro_torch.core.rotation import (RotationPlan, rotate_arena,
                                       rotate_arena_frozen)
from repro_torch.core.types import (CFState, clone_state, require_device,
                                    set0_cap)
from repro_torch.distributed.replication import ReplicatedArena
from repro_torch.kernels.knn_score.ops import knn_recommend_topn
from repro_torch.kernels.verify_rows.ops import arena_healthy
from repro_torch.serving import guard
from repro_torch.serving.config import ServerConfig
from repro_torch.serving.dedup import dedup_rows
from repro_torch.serving.wal import WriteAheadLog
from repro_torch.spans import RECORDER
from repro_torch.training import checkpoint
from repro_torch.training.elastic import Action, StragglerMonitor

log = logging.getLogger(__name__)

# Degradation ladder levels (ascending = more degraded).
LEVEL_TWINSEARCH = 0
LEVEL_TRADITIONAL = 1
LEVEL_DEGRADED = 2          # replica redundancy lost; rebuilding in background
LEVEL_SHED = 3
LEVEL_NAMES = {LEVEL_TWINSEARCH: "twinsearch",
               LEVEL_TRADITIONAL: "traditional",
               LEVEL_DEGRADED: "degraded",
               LEVEL_SHED: "shed"}

# Shed-rung query degradation: reads are served with k_neighbors // this
# (floor 1) instead of being refused.
SHED_QUERY_K_DIV = 4

# The checkpoint ``extra`` key of the probe generator's state.
GENERATOR_KEY = "torch_generator_state"


def _between_ms(first, last) -> float:
    """Milliseconds from the start of span ``first`` to the end of span
    ``last``."""
    return (last.t0 + last.ns - first.t0) * 1e-6


@dataclass
class ServerStats:
    """The server's counters and timings, always on.

    Every timing is the host duration of a span of ``repro_torch.spans``
    (the same start and stop points), appended when the span closes:
    ``onboard_ms`` of ``cf_server.compute``, ``rotation_ms`` of
    ``cf_server.rotate`` (or an incremental plan's summed steps),
    ``rotation_pause_ms`` of ``cf_server.rotate`` or
    ``cf_server.rotation_pause``, ``query_ms`` from the start of
    ``knn.top_k`` to the end of ``knn.score`` / ``knn.predict``,
    ``wal_append_ms``, ``add_rating_ms`` (``cf_server.apply_rating``),
    ``cache_init_ms``, ``plan_step_ms``, ``snapshot_save_ms`` and
    ``replica_reset_ms`` of the span named after them, and the two
    ``recover_*_ms`` of ``cf_server.recover_restore`` / ``_replay``.

    The deques are rings: ``latency_window`` (1,024) entries for
    ``onboard_ms``, ``query_ms``, ``query_dedup_savings``,
    ``wal_append_ms``, ``add_rating_ms`` and ``plan_step_ms``; 64 for
    ``rotation_ms``, ``rotation_pause_ms``, ``cache_init_ms``,
    ``snapshot_save_ms`` and ``replica_reset_ms``.  ``summary()``'s
    percentiles and maxima cover those trailing entries only; the counters
    cover the server's life."""
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
    repairs: int = 0            # poisoned rows healed from replicas
    degradations: int = 0
    recoveries: int = 0
    wal_appends: int = 0
    wal_replayed: int = 0
    plan_restarts: int = 0      # incremental-rotation precompute restarts
    forced_drains: int = 0      # buffer filled before the plan finished
    queries: int = 0            # query rows served (valid rows only)
    query_batches: int = 0      # recommend_batch / predict_batch calls
    query_unique: int = 0       # rows actually scored after twin dedup
    query_degraded: int = 0     # rows served at shed-reduced k_neighbors
    recover_restore_ms: float = 0.0   # checkpoint restore in ``recover``
    recover_replay_ms: float = 0.0    # WAL replay in ``recover``
    latency_window: int = 1024
    onboard_ms: deque = field(init=False)
    rotation_ms: deque = field(init=False)
    rotation_pause_ms: deque = field(init=False)
    query_ms: deque = field(init=False)
    query_dedup_savings: deque = field(init=False)
    wal_append_ms: deque = field(init=False)
    add_rating_ms: deque = field(init=False)
    cache_init_ms: deque = field(init=False)
    plan_step_ms: deque = field(init=False)
    snapshot_save_ms: deque = field(init=False)
    replica_reset_ms: deque = field(init=False)

    def __post_init__(self) -> None:
        # Fixed-size ring buffers: sustained traffic must not grow host
        # memory; summary() percentiles are over the trailing window.
        self.onboard_ms = deque(maxlen=self.latency_window)
        self.rotation_ms = deque(maxlen=64)
        # What rotation cost a *single request*: the synchronous stall
        # (full rotation, or just the final swap when incremental).
        self.rotation_pause_ms = deque(maxlen=64)
        self.query_ms = deque(maxlen=self.latency_window)
        self.query_dedup_savings = deque(maxlen=self.latency_window)
        # The write path: a WAL append (its fsync included, unless inside a
        # group commit), a whole add_rating call (the dots cache's build
        # included), the cache build alone, one maintenance tick's plan
        # step, and a durable checkpoint save.
        self.wal_append_ms = deque(maxlen=self.latency_window)
        self.add_rating_ms = deque(maxlen=self.latency_window)
        self.cache_init_ms = deque(maxlen=64)
        self.plan_step_ms = deque(maxlen=self.latency_window)
        self.snapshot_save_ms = deque(maxlen=64)
        # Replication: a full rebuild of every live replica from the arena
        # (construction, and after each rotation, swap or rollback).
        self.replica_reset_ms = deque(maxlen=64)

    def summary(self) -> dict:
        ms = sorted(self.onboard_ms) or [0.0]
        rot = sorted(self.rotation_ms) or [0.0]
        qms = sorted(self.query_ms) or [0.0]
        wal = sorted(self.wal_append_ms) or [0.0]
        add = sorted(self.add_rating_ms) or [0.0]
        step = sorted(self.plan_step_ms) or [0.0]
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
            "repairs": self.repairs,
            "degradations": self.degradations,
            "recoveries": self.recoveries,
            "wal_appends": self.wal_appends,
            "wal_replayed": self.wal_replayed,
            "plan_restarts": self.plan_restarts,
            "forced_drains": self.forced_drains,
            "onboard_p50_ms": ms[len(ms) // 2],
            "onboard_p99_ms": ms[min(len(ms) - 1, int(len(ms) * 0.99))],
            "rotation_p50_ms": rot[len(rot) // 2],
            "rotation_max_ms": rot[-1],
            "rotation_pause_max_ms": max(self.rotation_pause_ms, default=0.0),
            "queries": self.queries,
            "query_batches": self.query_batches,
            "query_unique": self.query_unique,
            "query_degraded": self.query_degraded,
            "query_p50_ms": qms[len(qms) // 2],
            "query_p99_ms": qms[min(len(qms) - 1, int(len(qms) * 0.99))],
            "query_dedup_savings": (1.0 - self.query_unique
                                    / max(self.queries, 1)),
            "wal_append_p50_ms": wal[len(wal) // 2],
            "wal_append_p99_ms": wal[min(len(wal) - 1, int(len(wal) * 0.99))],
            "add_rating_p50_ms": add[len(add) // 2],
            "add_rating_p99_ms": add[min(len(add) - 1, int(len(add) * 0.99))],
            "cache_init_max_ms": max(self.cache_init_ms, default=0.0),
            "plan_step_p50_ms": step[len(step) // 2],
            "plan_step_max_ms": step[-1],
            "snapshot_save_max_ms": max(self.snapshot_save_ms, default=0.0),
            "replica_reset_max_ms": max(self.replica_reset_ms, default=0.0),
            "recover_restore_ms": self.recover_restore_ms,
            "recover_replay_ms": self.recover_replay_ms,
        }


# Legacy dict-key -> OnboardResult attribute (identity for the rest).
_RESULT_KEY_MAP = {"ms": "latency_ms", "level": "rung"}


@dataclass(frozen=True)
class OnboardResult:
    """Typed outcome of ``onboard_user`` / ``onboard_batch``.

    The reference's legacy shapes work as there: iterating yields
    ``(user_id, result)``, so ``uid, info = srv.onboard_user(r)`` unpacks,
    and ``result["ms"]`` / ``result["level"]`` / ``result.get(...)``
    resolve through the legacy key names (``ms`` -> ``latency_ms``,
    ``level`` -> ``rung``).
    """
    user_id: int = -1
    status: str = "ok"        # ok|rejected|shed|error|rolled_back
    rung: str = "twinsearch"  # ladder level the request was served at
    latency_ms: float = 0.0
    rotated: bool = False     # this request triggered/absorbed a rotation
    seq: int = -1             # WAL sequence number (-1: nothing logged)
    twin_found: bool = False
    reason: str | None = None
    detail: str | None = None
    retry_after_s: float | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    # -- legacy (user_id, info_dict) compatibility --------------------------

    def __iter__(self):
        yield self.user_id
        yield self

    def __getitem__(self, key):
        if isinstance(key, int):
            return (self.user_id, self)[key]
        try:
            return getattr(self, _RESULT_KEY_MAP.get(key, key))
        except AttributeError:
            raise KeyError(key) from None

    def get(self, key, default=None):
        try:
            val = self[key]
        except KeyError:
            return default
        return default if val is None else val

    def __contains__(self, key) -> bool:
        try:
            return self[key] is not None
        except KeyError:
            return False


class CFServer:
    def __init__(self, ratings, config: ServerConfig | None = None, *,
                 device: str | torch.device = "cuda",
                 recover: bool = False, **legacy):
        """Build the arena from ``ratings`` ((n, m), numpy or tensor, 0 =
        unrated) on ``device``.  Raises if ``device`` is CUDA and no card
        is present: the server never slides onto the CPU by itself.
        ``recover=True`` is ``CFServer.recover``.

        The historical flat kwargs (``capacity_extra=..., wal_dir=...``)
        still work, as in the reference: they round-trip through
        ``ServerConfig.from_kwargs`` with a ``DeprecationWarning``; passing
        them beside a ``config`` raises ``ValueError``."""
        if config is not None and legacy:
            raise ValueError(
                "pass either config=ServerConfig(...) or the legacy flat "
                f"kwargs, not both (got legacy keys {sorted(legacy)})")
        if config is None:
            if legacy:
                warnings.warn(
                    "CFServer's flat keyword arguments are deprecated; "
                    "pass config=ServerConfig(...) (see "
                    "repro_torch.serving.config, ServerConfig.from_kwargs "
                    "maps the old names)", DeprecationWarning, stacklevel=2)
            config = ServerConfig.from_kwargs(**legacy)
        self.device = require_device(device, "CFServer")
        self._cuda = self.device.type == "cuda"     # device spans' events
        self.config = config
        self._rcfg = config.rotation
        self._wcfg = config.wal

        self.n_base = int(ratings.shape[0])
        self.c = config.c_probes
        self.tol = config.sim_tol
        self.rating_range = (float(config.rating_range[0]),
                             float(config.rating_range[1]))
        self.rotate_headroom = float(config.rotation.headroom)
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
        self.snapshot_dir = config.snapshot.dir
        self.snapshot_keep = int(config.snapshot.keep)
        self.check_every = int(config.snapshot.check_every)
        self._since_snapshot = 0
        self._since_check = 0

        # Incremental rotation: the pending plan (None = no rotation in
        # flight; always None when rotation.budget_rows == 0).
        self._plan: RotationPlan | None = None

        # ``_seq`` is the monotonic mutation counter: it numbers WAL
        # records AND disk checkpoints, so "checkpoint at S plus WAL
        # records with seq > S" is always the current state.
        self._seq = 0
        self.wal = (WriteAheadLog(config.wal.dir, fsync=config.wal.fsync)
                    if config.wal.dir is not None else None)
        self._replaying = False
        self._crash_hook = None        # test seam: see testing/faults.py
        self.replicas: ReplicatedArena | None = None
        # Every callable that computes similarities, besides the ``_onboard``
        # method: plain functions (a bound method would make the server a
        # reference cycle), replaced by ``forbid_similarity_kernels``.
        self._onboard_trad = base_lib.onboard_traditional
        self._init_cache = upd_lib.init_cache
        self._add = upd_lib.add_rating
        self._refresh_cache = upd_lib.refresh_rows
        self._cache: upd_lib.SimCache | None = None   # computed lazily
        # Rows the cache covers.  Onboarding appends rows without touching
        # the cache; the reference then divides by their cached squared
        # norm of 0 (sims near 1e11).  The port refreshes those rows first.
        self._cache_rows = 0

        with RECORDER.request("cf_server.init"):
            self._build(ratings, recover)

    def _build(self, ratings, recover: bool) -> None:
        """The arena (built, or restored and replayed), the replicas and
        the first snapshot."""
        config = self.config
        restored = fell_back = False
        if recover and self.snapshot_dir is not None:
            with RECORDER.span("cf_server.recover_restore") as span:
                restored, fell_back = self._restore_checkpoint()
                self._sync()
            self.stats.recover_restore_ms = span.ms
        if not restored:
            self.state: CFState = knn.build_state(
                torch.as_tensor(ratings).to(self.device),
                capacity_extra=config.capacity_extra, measure=config.measure)
        self._retarget()
        if recover and self.wal is not None:
            with RECORDER.span("cf_server.recover_replay") as span:
                self._replay_wal(restored, fell_back)
                self._sync()
            self.stats.recover_replay_ms = span.ms

        if config.replication is not None:
            self._sync()            # the build's work is not the reset's
            with RECORDER.span("cf_server.replica_reset") as span:
                self.replicas = ReplicatedArena(self.state,
                                                config.replication)
            self.stats.replica_reset_ms.append(span.ms)

        self._snapshot = None
        self._take_snapshot()       # the construction-time good state

    @classmethod
    def recover(cls, ratings, config: ServerConfig | None = None, *,
                device: str | torch.device = "cuda") -> "CFServer":
        """Rebuild a server after a crash: restore the newest durable
        checkpoint under the snapshot dir (falling back past corrupt
        steps), then replay the WAL suffix through the same ops — the
        recovered arena is bit-identical to the pre-crash one, with zero
        similarity recompute for checkpointed state.  Pass the same
        ``ratings`` and config as the original server."""
        return cls(ratings, config, device=device, recover=True)

    # -- internal machinery -------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _retarget(self) -> None:
        """Derived geometry after a build, rotation, rollback or restore."""
        self.k_cap = self.state.capacity - self.n_base
        self.s_max = set0_cap(self.n_base)

    def _draw_probes(self) -> torch.Tensor:
        """(c,) random probe ids over the base population, from the
        server's CPU generator (the same draws on every device)."""
        return torch.randint(0, self.n_base, (self.c,), generator=self._gen)

    def _onboard(self, state: CFState, r0: torch.Tensor, probes):
        """TwinSearch onboard (a seam ``testing.faults.Flaky`` wraps on an
        instance)."""
        return ts.onboard_twinsearch(state, r0, probes, s_max=self.s_max,
                                     n_base=self.n_base, k_cap=self.k_cap,
                                     tol=self.tol)

    def _reject(self, kind: str, reason: str, payload=None,
                detail: str = "") -> dict:
        self.stats.rejected += 1
        self.quarantine.record(kind, reason, payload, detail)
        return {"status": "rejected", "reason": reason}

    def _crashpoint(self, name: str) -> None:
        """Deterministic crash injection seam (``testing/faults.py``
        installs the hook); a no-op in production."""
        if self._crash_hook is not None:
            self._crash_hook(name)

    # -- degradation ladder -------------------------------------------------

    def _replicas_degraded(self) -> bool:
        return self.replicas is not None and self.replicas.degraded()

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
        """One recovery step down the ladder.  The ``degraded`` rung is
        owned by replication: stepping out of SHED lands on it while
        redundancy is still lost, and the rung itself is pinned until
        re-replication completes (``_replication_tick`` releases it)."""
        if self.level == LEVEL_SHED:
            self._set_level(LEVEL_DEGRADED if self._replicas_degraded()
                            else LEVEL_TRADITIONAL)
        elif self.level == LEVEL_DEGRADED:
            if not self._replicas_degraded():
                self._set_level(LEVEL_TRADITIONAL)
        else:
            self._set_level(max(LEVEL_TWINSEARCH, self.level - 1))

    def _apply_monitor(self, action: Action) -> None:
        if action is Action.ABORT:
            # A hang-scale latency: shed immediately, don't walk the ladder.
            self._set_level(LEVEL_SHED)
        elif action is Action.CHECKPOINT_AND_SHRINK:
            # Latency verdicts walk twinsearch -> traditional -> shed; the
            # degraded rung is entered only by replica-loss events.
            self._set_level(LEVEL_TRADITIONAL
                            if self.level == LEVEL_TWINSEARCH
                            else LEVEL_SHED)
        else:
            self._healthy_streak += 1
            if (self.level > LEVEL_TWINSEARCH
                    and self._healthy_streak >= self.recover_after):
                self._step_down()

    def _replication_tick(self) -> None:
        """Per-request background replication work: advance re-replication
        by the configured row budget and keep the ladder's ``degraded``
        rung in sync with actual redundancy."""
        if self.replicas is None:
            return
        self.replicas.step_rebuild()
        if self.replicas.degraded():
            if self.level < LEVEL_DEGRADED:
                self._set_level(LEVEL_DEGRADED)
        elif self.level == LEVEL_DEGRADED:
            self._set_level(LEVEL_TRADITIONAL)

    def _reset_replicas(self) -> None:
        """Re-mirror every live replica from the arena after a geometry
        change (rotation, swap, rollback), timed into
        ``stats.replica_reset_ms``."""
        if self.replicas is None:
            return
        self._sync()
        with RECORDER.span("cf_server.replica_reset") as span:
            self.replicas.reset(self.state)
        self.stats.replica_reset_ms.append(span.ms)

    # -- rotation -----------------------------------------------------------

    def _rotate(self) -> None:
        """Grow the arena: compact the write region into a new base (see
        ``core/rotation.py``).  The update cache keys on the old shapes
        and is dropped; replicas re-mirror the new geometry."""
        old_capacity = self.state.capacity
        self._cache = None
        with RECORDER.span("cf_server.rotate", device=self._cuda) as span:
            self.state = rotate_arena(self.state, n_base=self.n_base,
                                      extra=self.k_cap,
                                      headroom=self.rotate_headroom)
            self._sync()
        dt_ms = span.ms
        self.n_base = self.state.n_active
        self._retarget()
        self.stats.rotations += 1
        self.stats.rotation_ms.append(dt_ms)
        # Synchronous rotation: the triggering request stalls for all of it.
        self.stats.rotation_pause_ms.append(dt_ms)
        self._reset_replicas()
        log.info("arena rotated: capacity %d -> %d (n_base=%d, %.1fms)",
                 old_capacity, self.state.capacity, self.n_base, dt_ms)

    # -- incremental rotation (rotation.budget_rows > 0) --------------------

    def _free_slots(self) -> int:
        return self.state.capacity - self.state.n_active

    def _reserve_slots(self) -> int:
        r = self._rcfg.reserve_slots
        return int(r) if r is not None else max(1, self.k_cap // 4)

    def _start_plan(self) -> None:
        k0 = self.state.n_active - self.n_base
        extra = max(self.k_cap,
                    int(math.ceil(self.rotate_headroom * self.k_cap)))
        self._plan = RotationPlan(self.state, n_base=self.n_base,
                                  extra=extra,
                                  chunk_rows=max(1, self._rcfg.budget_rows))
        log.info("incremental rotation started: n_base=%d burst=%d "
                 "extra=%d", self.n_base, k0, extra)

    def _maintenance_tick(self, budget_rows: int | None = None) -> None:
        """Advance background rotation by one bounded slice and swap when
        the plan completes.  Called at safe points only — between mutating
        ops, never inside one."""
        if self._rcfg.budget_rows <= 0:
            return
        if self._plan is None:
            if self.k_cap <= 0 or self._free_slots() > self._reserve_slots():
                return
            self._start_plan()
        budget = (int(budget_rows) if budget_rows is not None
                  else self._rcfg.budget_rows)
        if not self._plan.done:
            with RECORDER.span("cf_server.plan_step") as span:
                self._plan.step(self.state, budget)   # ends in a sync
            self.stats.plan_step_ms.append(span.ms)
            self._crashpoint("rotation.step")
        if self._plan.done:
            self._swap_rotation()

    def _drain_during_wait(self, delay_s: float) -> None:
        """Retry-backoff hook: spend otherwise-idle wait time on rotation
        *chunks*.  Never swaps — a retry is mid-onboard."""
        if (self._plan is not None and not self._plan.done
                and self._rcfg.budget_rows > 0):
            self._plan.step(self.state, self._rcfg.budget_rows)

    def _force_drain(self) -> None:
        """The buffer filled before the plan finished (or before it even
        started): finish the rotation now, synchronously — in the worst
        case exactly the synchronous rotation's stall, never worse."""
        if self._plan is None:
            self._start_plan()
        else:
            self.stats.forced_drains += 1
        while not self._plan.done:
            self._plan.step(self.state, max(1, self.n_base))
        self._swap_rotation()

    def _swap_rotation(self) -> None:
        """The atomic swap: log ``rotate_commit``, finalize the plan from
        the live state (bit-identical to ``rotate_arena_frozen``), and
        retarget geometry.  The record carries the frozen boundary so
        recovery replays the swap at the same point in the op stream."""
        plan = self._plan
        old_capacity = self.state.capacity
        # Dropped at the install anyway; dropping it first keeps the dots
        # cache off the card while the new arena is assembled.
        self._cache = None
        with RECORDER.span("cf_server.rotation_pause",
                           device=self._cuda) as span:
            self._log("rotate_commit", fields={"n_base": plan.n_base,
                                               "n_frozen": plan.n_frozen,
                                               "extra": plan.extra})
            self._crashpoint("rotation.commit_post_wal")
            new_state = plan.finalize(self.state)
        pause_ms = span.ms
        self._install_rotated(new_state, n_base=plan.n_frozen)
        self._plan = None
        self.stats.rotations += 1
        self.stats.rotation_ms.append(plan.elapsed_ms)
        self.stats.rotation_pause_ms.append(pause_ms)
        self.stats.plan_restarts += plan.restarts
        self._crashpoint("rotation.post_swap")
        log.info("arena rotated (incremental): capacity %d -> %d "
                 "(n_base=%d, %.1fms total, %.1fms pause)", old_capacity,
                 self.state.capacity, self.n_base, plan.elapsed_ms,
                 pause_ms)

    def _install_rotated(self, new_state: CFState, *, n_base: int) -> None:
        """Point the server at a rotated arena (live swap or WAL replay)."""
        self.state = new_state
        self.n_base = int(n_base)
        self._cache = None
        self._retarget()
        self._reset_replicas()

    def step_maintenance(self, budget_rows: int | None = None) -> dict:
        """Public maintenance tick: drain up to ``budget_rows`` rows of any
        pending incremental rotation (defaults to the configured
        per-onboard budget), so rotations finish between bursts instead of
        inside them."""
        with RECORDER.request("cf_server.step_maintenance"):
            self._maintenance_tick(budget_rows)
        plan = self._plan
        return {"active": plan is not None,
                "remaining_rows": plan.remaining_rows if plan else 0,
                "free_slots": self._free_slots()}

    # -- durability: WAL / snapshot / rollback / recovery -------------------

    def _log(self, op: str, fields: dict | None = None,
             arrays: dict | None = None) -> int:
        """Assign the next mutation sequence number and (when a WAL is
        attached and we are not replaying) append the record *before* the
        op is applied — the write-ahead contract."""
        self._seq += 1
        if self.wal is not None and not self._replaying:
            with RECORDER.span("cf_server.wal_append") as span:
                self.wal.append(self._seq, op, fields, arrays)
            self.stats.wal_append_ms.append(span.ms)
            self.stats.wal_appends += 1
        return self._seq

    def _take_snapshot(self) -> None:
        # Drop the old snapshot first: two full clones need not coexist.
        self._snapshot = None
        with RECORDER.span("cf_server.snapshot", device=self._cuda):
            self._snapshot = (clone_state(self.state), self.n_base,
                              self._gen.get_state(), self._seq)
        self.stats.snapshots += 1
        self._since_snapshot = 0
        if self.snapshot_dir is not None:
            with RECORDER.span("cf_server.snapshot_save") as span:
                checkpoint.save(self.snapshot_dir, self._seq, self.state,
                                extra={"n_base": self.n_base,
                                       GENERATOR_KEY:
                                           self._gen.get_state().tolist(),
                                       "wal_seq": self._seq},
                                keep_last=self.snapshot_keep)
            self.stats.snapshot_save_ms.append(span.ms)
            if self.wal is not None:
                # The checkpoint subsumes every logged op; drop them.  The
                # dots cache is re-seeded at this boundary so a replayed
                # timeline (which must init it from the restored ratings)
                # stays bit-identical to the live one.
                self.wal.truncate_through(self._seq)
                self._cache = None

    def _rollback(self) -> None:
        snap, n_base, gen_state, seq = self._snapshot
        self._cache = None
        self._plan = None          # precomputed against the discarded state
        # The live state is written in place: restore from a clone so the
        # snapshot stays good for a later rollback.
        self.state = clone_state(snap)
        self.n_base = n_base
        self._gen.set_state(gen_state)
        self._seq = seq
        self._retarget()
        if self.wal is not None:
            self.wal.truncate_after(seq)
        self._reset_replicas()
        self.stats.rollbacks += 1
        self._since_check = 0
        self._since_snapshot = 0
        log.error("arena invariant violated; rolled back to last good "
                  "snapshot (n_active=%d)", snap.n_active)

    def _restore_checkpoint(self) -> tuple[bool, bool]:
        """Restore the newest loadable checkpoint into the server; returns
        (restored, fell back past a newer corrupt step)."""
        template = CFState(*(torch.empty(0, dtype=dt, device=self.device)
                             for dt in (torch.float32, torch.float32,
                                        torch.float32, torch.int32)), 0)
        try:
            state, step, extra = checkpoint.restore(self.snapshot_dir,
                                                    template)
        except FileNotFoundError:
            return False, False
        self.state = state
        self.n_base = int(extra.get("n_base", self.n_base))
        if GENERATOR_KEY in extra:
            self._gen.set_state(torch.tensor(extra[GENERATOR_KEY],
                                             dtype=torch.uint8))
        self._seq = int(extra.get("wal_seq", step))
        log.info("restored checkpoint step %d (n_active=%d)", step,
                 state.n_active)
        newest = checkpoint.latest_step(self.snapshot_dir)
        return True, newest is not None and newest > step

    def _replay_wal(self, restored: bool, fell_back: bool) -> None:
        """Replay the WAL suffix past the restored state.  Zero similarity
        math for checkpointed state: replay re-runs only the logged ops."""
        # Gap checks run on the WAL's *raw* sequence bounds — aborted ops
        # and their compensation records count (records() filters them out
        # of the replay stream, but their seqs were consumed): an aborted
        # prefix is not a missing prefix, and replaying over a genuinely
        # missing one would silently drop committed ops.
        first_raw = self.wal.first_seq
        if not restored:
            if first_raw > 1:
                raise RuntimeError(
                    f"WAL starts at seq {first_raw} but no checkpoint "
                    f"could be restored — earlier ops were truncated "
                    f"into a checkpoint that is now missing or corrupt")
        elif (first_raw > self._seq + 1
                or (fell_back and first_raw == 0)):
            # The newest checkpoint was corrupt and the WAL was already
            # truncated through it: the ops between the fallback step and
            # the corrupt one are unrecoverable.  (A crash between
            # checkpoint.save and the WAL truncation leaves the suffix
            # intact — first_seq <= wal_seq + 1 — and recovers fine.)
            where = ("is empty" if first_raw == 0
                     else f"starts at seq {first_raw}")
            raise RuntimeError(
                f"restored checkpoint is at seq {self._seq} but the WAL "
                f"{where} — ops since seq {self._seq} were truncated into a "
                f"newer checkpoint that is corrupt; refusing to replay "
                f"over the gap")
        self._replay(self.wal.records(after_seq=self._seq))
        # Resume numbering past the raw WAL tail: an aborted tail op's seq
        # (and its abort record's) never replays, but reissuing it would
        # make records() drop the next committed op as aborted on a later
        # recovery.
        self._seq = max(self._seq, self.wal.last_seq)

    def _replay(self, records) -> None:
        """Replay WAL records one by one through the live path's ops (see
        the module docstring on ``wal.replay_batch``)."""
        self._replaying = True
        try:
            for rec in records:
                self._seq = rec.seq
                if rec.op == "rotate":
                    self._rotate()
                elif rec.op == "rotate_commit":
                    self._replay_rotate_commit(rec)
                elif rec.op == "onboard":
                    self._replay_onboard(rec)
                elif rec.op == "add_rating":
                    f = rec.fields
                    self._apply_add_rating(int(f["user"]), int(f["item"]),
                                           float(f["rating"]))
                else:
                    log.warning("unknown WAL op %r at seq %d skipped",
                                rec.op, rec.seq)
                self.stats.wal_replayed += 1
        finally:
            self._replaying = False

    def _replay_rotate_commit(self, rec) -> None:
        """Replay of an incremental rotation's swap: the record pins the
        frozen boundary and growth, so ``rotate_arena_frozen`` reproduces
        the swapped arena bit-exactly at the same point in the op
        stream."""
        f = rec.fields
        self._cache = None
        new_state = rotate_arena_frozen(
            self.state, n_base=int(f["n_base"]),
            n_frozen=int(f["n_frozen"]), extra=int(f["extra"]))
        self._sync()
        self._install_rotated(new_state, n_base=int(f["n_frozen"]))
        self.stats.rotations += 1

    def _replay_onboard(self, rec) -> None:
        r0 = torch.as_tensor(rec.arrays["ratings"].astype(np.float32),
                             device=self.device)
        if bool(rec.fields.get("use_twin", False)):
            # Advance the generator exactly as the live path did; the
            # recorded probes are authoritative (recovery works even from
            # a foreign generator state, or a log the reference wrote).
            self._draw_probes()
            probes = torch.as_tensor(rec.arrays["probes"].astype(np.int64))
            new_state, res = self._onboard(self.state, r0, probes)
            found, overflowed = bool(res.found), bool(res.overflowed)
        else:
            new_state = self._onboard_trad(self.state, r0)
            found = overflowed = False
        self._sync()
        self._commit_onboard(new_state, found, overflowed)

    # -- health check + snapshot cadence ------------------------------------

    def _healthy(self) -> bool:
        st = self.state
        with RECORDER.span("cf_server.health"):
            return bool(arena_healthy(st.sim_vals, st.ratings, st.norms,
                                      st.n_active))

    def _state_ok(self) -> bool:
        """Verify the arena invariant; heal poisoned rows from replicas
        (exact, similarity-free) when possible, roll back to the last good
        snapshot otherwise.  False iff a rollback happened."""
        if self._healthy():
            return True
        if self.replicas is not None:
            fixed, rows = self.replicas.repair(self.state)
            if fixed is not None and self._healthy():
                self._cache = None
                self.stats.repairs += 1
                log.warning("healed %d poisoned arena rows from replicas",
                            len(rows))
                return True
        self._rollback()
        return False

    def _check_and_snapshot(self) -> bool:
        """Periodic poison detection + snapshot cadence.  Returns False if
        the state failed the invariant and was rolled back (a
        replica-healed state counts as healthy)."""
        self._since_check += 1
        self._since_snapshot += 1
        if self._since_check >= self.check_every:
            self._since_check = 0
            if self.replicas is not None:
                self.replicas.sweep()
            if not self._state_ok():
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
        if self.replicas is not None:
            self.replicas.apply_rows([new_state.n_active - 1], new_state)

    def onboard_user(self, ratings: np.ndarray, *,
                     use_twinsearch: bool = True) -> OnboardResult:
        with RECORDER.request("cf_server.onboard_user"):
            return self._onboard_user(ratings, use_twinsearch)

    def _onboard_user(self, ratings: np.ndarray,
                      use_twinsearch: bool) -> OnboardResult:
        with RECORDER.span("cf_server.guard"):
            reason = guard.validate_ratings_vector(
                ratings, n_items=self.state.n_items,
                rating_range=self.rating_range)
        if reason is not None:
            self._reject("onboard", reason, ratings)
            return OnboardResult(status="rejected", reason=reason,
                                 rung=LEVEL_NAMES[self.level])

        self._replication_tick()
        if self.level == LEVEL_SHED:
            if self._clock() < self._shed_until:
                self.stats.shed += 1
                if self.config.ladder.drain_on_shed:
                    # Backpressure time is free maintenance time.
                    self._maintenance_tick()
                return OnboardResult(
                    status="shed", rung=LEVEL_NAMES[self.level],
                    retry_after_s=self._shed_until - self._clock())
            # Cooldown expired: probe the cheaper build path again.
            self._set_level(LEVEL_DEGRADED if self._replicas_degraded()
                            else LEVEL_TRADITIONAL)

        # Background rotation tick: a safe point (no op in flight).
        self._maintenance_tick()

        self._crashpoint("onboard.pre_wal")
        rotated = False
        if self.state.n_active >= self.state.capacity:
            rotated = True
            if self._rcfg.budget_rows > 0:
                # The plan didn't finish (or start) in time: drain it now.
                self._force_drain()
            else:
                self._log("rotate")
                self._crashpoint("rotate.post_wal")
                self._rotate()

        with RECORDER.span("cf_server.upload"):
            r0_np = np.asarray(ratings, dtype=np.float32)
            r0 = torch.as_tensor(r0_np, device=self.device)
        use_twin = use_twinsearch and self.level == LEVEL_TWINSEARCH
        if use_twin:
            probes = self._draw_probes()

            def run():
                new_state, res = self._onboard(self.state, r0, probes)
                found, ovf = bool(res.found), bool(res.overflowed)
                self._sync()
                return new_state, found, ovf
        else:
            probes = None

            def run():
                new_state = self._onboard_trad(self.state, r0)
                self._sync()
                return new_state, False, False

        seq = self._log(
            "onboard", fields={"use_twin": bool(use_twin)},
            arrays={"ratings": r0_np,
                    "probes": (probes.numpy().astype(np.int32)
                               if probes is not None
                               else np.empty((0,), np.int32))})
        self._crashpoint("onboard.post_wal")

        # Retry backoff waits double as maintenance ticks: time blocked on a
        # transient fault drains the rotation plan instead of idling.  The
        # policy is built per call: a bound method stored on the server
        # would make it a reference cycle, and a dropped server would then
        # hold its arena on the card until the cyclic collector runs.
        policy = (self.retry if self.retry.on_wait is not None
                  else dataclasses.replace(self.retry,
                                           on_wait=self._drain_during_wait))
        self.monitor.step_started()
        try:
            with RECORDER.span("cf_server.compute") as compute:
                (new_state, found, overflowed), retries = \
                    guard.call_with_retry(run, policy)
        except Exception as e:          # noqa: BLE001 — contract: no raise
            self.monitor.step_finished()
            self.stats.errors += 1
            # Compensate the write-ahead record: the op never applied, so
            # replay must skip it.
            self._log("abort", fields={"target": seq})
            self.quarantine.record("onboard", guard.R_ERROR, ratings,
                                   detail=repr(e))
            log.error("onboard failed after retries: %r", e)
            return OnboardResult(status="error", reason=guard.R_ERROR,
                                 rung=LEVEL_NAMES[self.level],
                                 rotated=rotated, seq=seq, detail=repr(e))
        dt_ms = compute.ms
        self._apply_monitor(self.monitor.step_finished())

        self.stats.retries += retries
        with RECORDER.span("cf_server.commit"):
            self._commit_onboard(new_state, found, overflowed)
        self.stats.onboard_ms.append(dt_ms)
        self._crashpoint("onboard.post_commit")

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
        """Onboard a sequence of users under one WAL group commit: the
        batch's appends coalesce into a single write+fsync
        (``wal.group_commit``), so a crash mid-batch replays to the last
        *flushed* batch boundary, never to a torn prefix.  Per-user
        ``OnboardResult``s, same contract as ``onboard_user``."""
        ctx = (self.wal.batch()
               if self.wal is not None and self._wcfg.group_commit
               else contextlib.nullcontext())
        with ctx:
            return [self.onboard_user(r, use_twinsearch=use_twinsearch)
                    for r in ratings_batch]

    # -- queries ------------------------------------------------------------

    def _query_k(self, k_neighbors: int) -> int:
        """The shed rung serves reads at a reduced neighbour count instead
        of refusing them."""
        if self.level == LEVEL_SHED:
            return max(1, int(k_neighbors) // SHED_QUERY_K_DIV)
        return int(k_neighbors)

    def _pre_query(self) -> None:
        if self.replicas is not None:
            # Failover read: heal any poisoned rows from replicas before
            # answering, so a lost shard degrades durability, not answers.
            self._replication_tick()
            self._state_ok()

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
        with RECORDER.request("cf_server.recommend_batch"):
            return self._recommend_batch(users, n, k_neighbors)

    def _recommend_batch(self, users, n: int, k_neighbors: int
                         ) -> list[list[tuple[int, float]]]:
        users = list(users)
        results: list[list[tuple[int, float]]] = [[] for _ in users]
        valid = [i for i, u in enumerate(users)
                 if not (guard.validate_user_id(u, self.state.n_active)
                         and self._reject("recommend", guard.R_USER_ID, u))]
        if not valid:
            return results
        self._pre_query()
        k_eff = self._query_k(k_neighbors)

        with RECORDER.span("knn.top_k") as top:
            uvec = torch.as_tensor([int(users[i]) for i in valid],
                                   device=self.device)
            sims, nbrs = knn.top_k_neighbors_batch(self.state, uvec, k_eff)
            nbrs = nbrs.to(torch.int32)
            rows = self.state.ratings[uvec]
        # Twin dedup: the scoring kernel is a deterministic function of
        # exactly (sims, nbrs, own row), so equal keys share scores.
        with RECORDER.span("dedup.keys"):
            keys = np.concatenate([sims.cpu().numpy().view(np.uint32),
                                   nbrs.cpu().numpy().view(np.uint32),
                                   rows.cpu().numpy().view(np.uint32)],
                                  axis=1)
        with RECORDER.span("dedup.hash"):
            plan = dedup_rows(keys)
        with RECORDER.span("knn.score") as score:
            sel = torch.as_tensor(plan.unique_rows, device=self.device)
            scores, items = knn_recommend_topn(
                self.state.ratings, torch.clamp_min(sims[sel], 0.0),
                nbrs[sel], uvec[sel], n)
            scores, items = scores.cpu().numpy(), items.cpu().numpy()

        with RECORDER.span("cf_server.fan_out"):
            for pos, i in enumerate(valid):
                u = int(plan.scatter[pos])
                results[i] = [(int(it), float(s))
                              for s, it in zip(scores[u], items[u])]
        self._note_query_batch(len(valid), plan.n_unique, plan.savings,
                               _between_ms(top, score),
                               degraded=k_eff != int(k_neighbors))
        return results

    def predict_batch(self, users, items, k: int = 20) -> list[float]:
        """kNN rating predictions for B (user, item) pairs; invalid rows
        are quarantined and answer 0.0.  Twin dedup keys on (top-k sims,
        neighbour ids, item)."""
        with RECORDER.request("cf_server.predict_batch"):
            return self._predict_batch(users, items, k)

    def _predict_batch(self, users, items, k: int) -> list[float]:
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
        self._pre_query()
        k_eff = self._query_k(k)

        with RECORDER.span("knn.top_k") as top:
            uvec = torch.as_tensor([int(users[i]) for i in valid],
                                   device=self.device)
            ivec = np.asarray([int(items[i]) for i in valid], np.int32)
            sims, nbrs = knn.top_k_neighbors_batch(self.state, uvec, k_eff)
            nbrs = nbrs.to(torch.int32)
        with RECORDER.span("dedup.keys"):
            keys = np.concatenate([sims.cpu().numpy().view(np.uint32),
                                   nbrs.cpu().numpy().view(np.uint32),
                                   ivec.reshape(-1, 1).view(np.uint32)],
                                  axis=1)
        with RECORDER.span("dedup.hash"):
            plan = dedup_rows(keys)
        with RECORDER.span("knn.predict") as score:
            sel = torch.as_tensor(plan.unique_rows, device=self.device)
            preds = knn.predict_from_neighbors(
                self.state, sims[sel], nbrs[sel].long(),
                torch.as_tensor(ivec, device=self.device)[sel]).cpu().numpy()

        with RECORDER.span("cf_server.fan_out"):
            for pos, i in enumerate(valid):
                results[i] = float(preds[int(plan.scatter[pos])])
        self._note_query_batch(len(valid), plan.n_unique, plan.savings,
                               _between_ms(top, score),
                               degraded=k_eff != int(k))
        return results

    def recommend(self, user: int, n: int = 10,
                  k_neighbors: int = 20) -> list[tuple[int, float]]:
        """B=1 wrapper over ``recommend_batch``."""
        return self.recommend_batch([user], n=n, k_neighbors=k_neighbors)[0]

    def predict(self, user: int, item: int, k: int = 20) -> float:
        """B=1 wrapper over ``predict_batch``."""
        return self.predict_batch([user], [item], k=k)[0]

    # -- maintenance --------------------------------------------------------

    def _apply_add_rating(self, user: int, item: int,
                          rating: float) -> None:
        n_act = self.state.n_active
        if self._cache is None:
            with RECORDER.span("cf_server.cache_init") as span:
                self._cache = self._init_cache(self.state.ratings)
                self._sync()
            self.stats.cache_init_ms.append(span.ms)
        elif self._cache_rows < n_act:
            # Users onboarded since the cache was built (the reference
            # leaves their rows at 0 here: see ``_cache_rows``).
            self._refresh_cache(self._cache, self.state.ratings,
                                self._cache_rows, n_act)
        self._cache_rows = n_act
        self.state, self._cache = self._add(
            self.state, self._cache, user, item, rating)
        if self.replicas is not None:
            self.replicas.apply_rows([user], self.state)
        if self._plan is not None:
            # A refreshed row may invalidate part of the rotation plan's
            # precompute; the plan re-merges it before the swap.
            self._plan.note_write(user)

    def add_rating(self, user: int, item: int, rating: float) -> bool:
        """Returns True iff the update was applied (False = quarantined).
        An applied update is on the arena when the call returns (its time,
        WAL append included, is ``ServerStats.add_rating_ms``)."""
        with RECORDER.request("cf_server.add_rating"):
            return self._add_rating(user, item, rating)

    def _add_rating(self, user: int, item: int, rating: float) -> bool:
        if guard.validate_user_id(user, self.state.n_active):
            self._reject("add_rating", guard.R_USER_ID, user)
            return False
        if guard.validate_item_id(item, self.state.n_items):
            self._reject("add_rating", guard.R_ITEM_ID, item)
            return False
        reason = guard.validate_rating_value(rating, self.rating_range)
        if reason is not None:
            self._reject("add_rating", reason, rating)
            return False
        self._replication_tick()
        self._crashpoint("add_rating.pre_wal")
        with RECORDER.span("cf_server.apply_rating") as span:
            self._log("add_rating", fields={"user": int(user),
                                            "item": int(item),
                                            "rating": float(rating)})
            self._crashpoint("add_rating.post_wal")
            self._apply_add_rating(int(user), int(item), float(rating))
            self._sync()
        self.stats.add_rating_ms.append(span.ms)
        self._crashpoint("add_rating.post_commit")
        return True
