"""Deterministic fault injection for the CF serving path (PyTorch port of
the crash half of ``repro.testing.faults``).

  * **process crashes** (``SimulatedCrash`` + ``install_crash``): kill the
    server at a named crash point in the WAL-ordered mutation flow
    (before/after the log append, after commit, inside an incremental
    rotation) — ``SimulatedCrash`` derives from ``BaseException`` so it
    sails through every ``except Exception`` in the no-raise machinery,
    exactly like a real SIGKILL would;
  * **transient executor faults** (``Flaky``): a callable that raises for
    its first n invocations, exercising the retry / abort path;
  * **virtual time** (``FakeClock``): pass it to ``StragglerMonitor`` /
    ``RetryPolicy`` so ladder transitions are exact, not timing-dependent.

Replica loss and state poisoning (``kill_replica``, ``poison_state``,
``forbid_similarity_kernels``) come with replication.
"""
from __future__ import annotations

from typing import Callable


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
