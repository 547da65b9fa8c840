"""Deterministic fault injection for the CF serving path (PyTorch port of
``repro.testing.faults``).

Every fault a real fleet throws at the onboarding loop, reproducible from a
seed — no wall-clock sleeps, no flaky randomness:

  * **malformed requests** (``MalformedRequests``): NaN/Inf-poisoned rating
    vectors, truncated/over-long vectors, wrong dtypes, out-of-range
    values — everything ``serving/guard.py`` must refuse at the door;
  * **latency spikes** (``FakeClock`` + ``inject_latency``): the server's
    ``StragglerMonitor`` runs on an injectable clock; wrapping the onboard
    callables advances that clock by a scripted schedule, so
    degradation-ladder transitions are exact, not timing-dependent;
  * **transient executor faults** (``Flaky``): a callable that raises for
    its first n invocations, exercising the retry/backoff/deadline path;
  * **state poisoning** (``poison_state``): NaNs written straight into the
    arena — bypassing the guard, as a bit-flip or a lost shard's garbage
    rows would — including whole shard-row-slice loss via
    ``distributed.sharding.shard_row_slice``;
  * **capacity floods** (``capacity_flood``): a scripted onboard burst far
    past ``capacity_extra``, forcing repeated arena rotations;
  * **process crashes** (``SimulatedCrash`` + ``install_crash``): kill the
    server at a named crash point in the WAL-ordered mutation flow
    (before/after the log append, after commit, inside an incremental
    rotation) — ``SimulatedCrash`` derives from ``BaseException`` so it
    sails through every ``except Exception`` in the no-raise machinery,
    exactly like a real SIGKILL would;
  * **replica loss** (``kill_replica``): a node dies — its replica copies
    vanish (``ReplicatedArena.kill_node``) and the primary arena rows of
    its home shard turn to garbage — plus ``forbid_similarity_kernels``
    to prove recovery is pure data movement.

The harness mutates server-internal seams (the ``_onboard`` /
``_onboard_trad`` callables, the arena's tensors in place) on purpose: the
point is to model faults *below* the validated request surface.
"""
from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.distributed.sharding import shard_row_slice


class FakeClock:
    """Monotonic virtual clock — pass ``clock=fake`` to StragglerMonitor /
    RetryPolicy and advance it from fault hooks."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += float(dt)


class Flaky:
    """Delegates to ``fn`` after raising for the first ``fail_times``
    calls — a transient executor fault."""

    def __init__(self, fn: Callable, fail_times: int,
                 exc: Exception | None = None):
        self.fn = fn
        self.remaining = int(fail_times)
        self.exc = exc or RuntimeError("injected transient fault")
        self.calls = 0

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise self.exc
        return self.fn(*args, **kwargs)


class MalformedRequests:
    """Seeded factory of invalid rating vectors, one method per failure
    mode the guard must catch."""

    def __init__(self, n_items: int, seed: int = 0,
                 rating_range: tuple[float, float] = (1.0, 5.0)):
        self.m = int(n_items)
        self.rng = np.random.default_rng(seed)
        self.lo, self.hi = rating_range

    def _valid(self) -> np.ndarray:
        r = (self.rng.integers(int(self.lo), int(self.hi) + 1, self.m)
             * (self.rng.random(self.m) < 0.4)).astype(np.float32)
        r[0] = self.lo
        return r

    def nan_ratings(self) -> np.ndarray:
        r = self._valid()
        r[self.rng.integers(0, self.m, size=max(1, self.m // 8))] = np.nan
        return r

    def inf_ratings(self) -> np.ndarray:
        r = self._valid()
        r[self.rng.integers(0, self.m)] = np.inf
        return r

    def truncated(self) -> np.ndarray:
        return self._valid()[: self.m // 2]

    def overlong(self) -> np.ndarray:
        return np.concatenate([self._valid(), self._valid()])

    def wrong_dtype(self) -> np.ndarray:
        return np.array(["five"] * self.m, dtype=object)

    def out_of_range(self) -> np.ndarray:
        r = self._valid()
        r[self.rng.integers(0, self.m)] = self.hi * 100
        return r

    def all_zero(self) -> np.ndarray:
        return np.zeros(self.m, np.float32)

    def everything(self) -> list[tuple[str, np.ndarray]]:
        return [("nan", self.nan_ratings()), ("inf", self.inf_ratings()),
                ("truncated", self.truncated()),
                ("overlong", self.overlong()),
                ("wrong_dtype", self.wrong_dtype()),
                ("out_of_range", self.out_of_range()),
                ("all_zero", self.all_zero())]


def inject_latency(server, clock: FakeClock,
                   schedule: Sequence[float]) -> None:
    """Make the server's next onboard calls take scripted (virtual) time.

    Wraps both onboard callables so call t advances ``clock`` by
    ``schedule[t]`` — the StragglerMonitor (constructed with this clock)
    sees exactly those step times.  Past the schedule's end the wrapper
    falls back to the final entry."""
    schedule = [float(s) for s in schedule]
    counter = {"i": 0}

    def wrap(fn):
        def wrapped(*args, **kwargs):
            i = min(counter["i"], len(schedule) - 1)
            counter["i"] += 1
            clock.advance(schedule[i])
            return fn(*args, **kwargs)
        return wrapped

    server._onboard = wrap(server._onboard)
    server._onboard_trad = wrap(server._onboard_trad)


def poison_state(server, *, rows: Iterable[int] | None = None,
                 shard: int | None = None, n_shards: int = 1,
                 field: str = "sim_vals") -> np.ndarray:
    """NaN-poison arena rows in place, bypassing the request guard —
    simulating memory corruption or shard loss.

    ``shard``/``n_shards`` selects the row-sharded slice a dead shard
    would stop serving (``distributed.sharding.shard_row_slice``);
    ``rows`` selects explicit rows.  The rows of the server's tensor are
    written where it lives (the port's arena is mutated in place).
    Returns the poisoned row ids."""
    arr = getattr(server.state, field)
    if shard is not None:
        sl = shard_row_slice(arr.shape[0], n_shards, shard)
        row_ids = np.arange(sl.start, sl.stop)
    else:
        row_ids = np.asarray(list(rows if rows is not None else [0]))
    arr[row_ids] = float("nan")
    return row_ids


def capacity_flood(server, pool: np.ndarray, n: int,
                   seed: int = 0) -> list:
    """Onboard ``n`` users drawn deterministically from ``pool`` rows —
    sized to blow past ``capacity_extra`` and force rotations.  Returns
    the ``OnboardResult`` of each."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append(server.onboard_user(pool[rng.integers(0, len(pool))]))
    return out


class SimulatedCrash(BaseException):
    """Process death at a crash point.  Deliberately NOT an ``Exception``:
    the serving layer's no-raise machinery (retry wrapper, onboard
    try/except) catches ``Exception`` only, so this propagates out of any
    entrypoint the way a SIGKILL ends a process mid-op."""

    def __init__(self, point: str):
        super().__init__(f"simulated crash at {point!r}")
        self.point = point


# The named points ``CFServer._crashpoint`` visits, in mutation-flow order.
CRASH_POINTS = ("onboard.pre_wal", "rotate.post_wal", "onboard.post_wal",
                "onboard.post_commit", "add_rating.pre_wal",
                "add_rating.post_wal", "add_rating.post_commit")

# Crash points inside an *incremental* rotation (rotation.budget_rows > 0):
# after a precompute slice (nothing logged — recovery must match the state
# at the crash), after the ``rotate_commit`` WAL append but before the
# swap applied (recovery must replay the swap), and after the swap.
ROTATION_CRASH_POINTS = ("rotation.step", "rotation.commit_post_wal",
                         "rotation.post_swap")


def install_crash(server, point: str, *, nth: int = 1) -> None:
    """Arm the server's crash hook: the ``nth`` time execution reaches the
    named crash point, raise ``SimulatedCrash``.  The server object is
    dead after that — recovery means building a NEW server with
    ``CFServer.recover(...)`` over the same WAL and snapshot dirs."""
    remaining = {"n": int(nth)}

    def hook(name: str) -> None:
        if name == point:
            remaining["n"] -= 1
            if remaining["n"] <= 0:
                raise SimulatedCrash(point)

    server._crash_hook = hook


def kill_replica(server, node: int) -> np.ndarray:
    """Lose one node of the replicated arena: its replica copies are gone
    and the primary arena rows of its home shard (shard ``node`` under
    chained declustering) turn to garbage.  Returns the poisoned primary
    rows; the server must heal them from surviving replicas."""
    replicas = server.replicas
    if replicas is None:
        raise ValueError("server has no replication configured")
    replicas.kill_node(node)
    return poison_state(server, shard=node,
                        n_shards=replicas.cfg.n_shards)


def forbid_similarity_kernels(server) -> None:
    """Replace every similarity-computing callable on the server with a
    raiser — replica repair and re-replication must be pure data movement,
    and this makes any cheat raise immediately."""

    def boom(*_a, **_k):
        raise AssertionError("similarity kernel invoked during "
                             "replication recovery")

    server._onboard = boom
    server._onboard_trad = boom
    server._init_cache = boom
    server._add = boom
    server._refresh_cache = boom
