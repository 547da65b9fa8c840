"""Request validation, quarantine, and retry policy for the CF serving path.

Every request the server would hand to a jitted kernel passes through here
first.  A malformed payload (NaN/Inf ratings, wrong shape or dtype,
out-of-range values, bogus user/item ids) must never reach the compiled
program: a single NaN written into the similarity arena silently poisons
every downstream ``argsort``/``top_k``, and a wrong shape either recompiles
the kernel for a garbage signature or raises mid-update, leaving the state
half-written.  Rejected requests are *quarantined* — a bounded record of
what arrived and why it was refused, cheap enough to keep on the serving
hot path — and the caller gets a structured refusal instead of an
exception.

``call_with_retry`` is the transient-failure wrapper around the jitted
onboard call: exponential backoff with an overall deadline, with the sleep
and clock injectable so the fault-injection tests run in virtual time.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

# Rejection reasons (stable strings — they key quarantine counters).
R_DTYPE = "dtype"
R_SHAPE = "shape"
R_NON_FINITE = "non_finite"
R_RANGE = "range"
R_EMPTY = "empty"
R_USER_ID = "user_id"
R_ITEM_ID = "item_id"
R_ERROR = "error"          # the jitted call itself failed after retries


def _summarize(payload: Any) -> dict:
    """Small, jit-free description of a rejected payload (never the payload
    itself — quarantined data is recorded, not retained or re-fed)."""
    try:
        arr = np.asarray(payload)
        return {"shape": tuple(arr.shape), "dtype": str(arr.dtype)}
    except Exception:
        return {"type": type(payload).__name__}


@dataclass(frozen=True)
class Rejection:
    kind: str                  # which entrypoint refused ("onboard", ...)
    reason: str                # one of the R_* strings above
    detail: str = ""
    payload: dict = field(default_factory=dict)


@dataclass
class Quarantine:
    """Bounded record of refused requests + per-reason counters."""

    capacity: int = 256
    records: deque = field(init=False)
    counts: dict = field(default_factory=dict)
    total: int = 0

    def __post_init__(self) -> None:
        self.records = deque(maxlen=self.capacity)

    def record(self, kind: str, reason: str, payload: Any = None,
               detail: str = "") -> Rejection:
        rej = Rejection(kind=kind, reason=reason, detail=detail,
                        payload=_summarize(payload))
        self.records.append(rej)
        self.counts[reason] = self.counts.get(reason, 0) + 1
        self.total += 1
        return rej

    def summary(self) -> dict:
        return {"total": self.total, "by_reason": dict(self.counts),
                "held": len(self.records)}


# ---------------------------------------------------------------------------
# Validators — each returns a rejection reason or None (accepted).
# ---------------------------------------------------------------------------

def validate_ratings_vector(r: Any, *, n_items: int,
                            rating_range: tuple[float, float]) -> str | None:
    """One user's dense rating vector: (n_items,) numeric, finite, every
    non-zero value inside ``rating_range`` (0 = unrated), not all-zero."""
    try:
        arr = np.asarray(r)
    except Exception:
        return R_DTYPE
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        return R_DTYPE
    if arr.ndim != 1 or arr.shape[0] != n_items:
        return R_SHAPE
    arr = arr.astype(np.float64, copy=False)
    if not np.all(np.isfinite(arr)):
        return R_NON_FINITE
    lo, hi = rating_range
    rated = arr != 0
    if not rated.any():
        return R_EMPTY                  # zero-norm row: cosine undefined
    if np.any(rated & ((arr < lo) | (arr > hi))):
        return R_RANGE
    return None


def validate_rating_value(v: Any,
                          rating_range: tuple[float, float]) -> str | None:
    """A single rating: finite scalar, 0 (removal) or inside the range."""
    try:
        x = float(v)
    except (TypeError, ValueError):
        return R_DTYPE
    if not np.isfinite(x):
        return R_NON_FINITE
    lo, hi = rating_range
    if x != 0 and not (lo <= x <= hi):
        return R_RANGE
    return None


def validate_user_id(user: Any, n_active: int) -> str | None:
    try:
        u = int(user)
    except (TypeError, ValueError):
        return R_USER_ID
    if not 0 <= u < n_active:
        return R_USER_ID
    return None


def validate_item_id(item: Any, n_items: int) -> str | None:
    try:
        i = int(item)
    except (TypeError, ValueError):
        return R_ITEM_ID
    if not 0 <= i < n_items:
        return R_ITEM_ID
    return None


# ---------------------------------------------------------------------------
# Retry with exponential backoff + deadline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RetryPolicy:
    max_attempts: int = 3
    base_delay_s: float = 0.01
    deadline_s: float = 5.0
    backoff: float = 2.0
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic
    # Called with the upcoming delay right before each backoff sleep — the
    # server uses it to drain background maintenance (rotation chunks)
    # during time it would otherwise spend blocked.
    on_wait: Callable[[float], None] | None = None


def call_with_retry(fn: Callable[[], Any],
                    policy: RetryPolicy) -> tuple[Any, int]:
    """Run ``fn`` with exponential backoff; returns (result, n_retries).

    Re-raises the last exception once attempts are exhausted or the next
    backoff would blow the deadline — the *caller* (the server) converts
    that into a quarantined structured failure; this helper stays honest
    about whether the call ever succeeded.
    """
    start = policy.clock()
    delay = policy.base_delay_s
    last: BaseException | None = None
    for attempt in range(policy.max_attempts):
        try:
            return fn(), attempt
        except Exception as e:            # noqa: BLE001 — wrapped, re-raised
            last = e
            elapsed = policy.clock() - start
            if (attempt + 1 >= policy.max_attempts
                    or elapsed + delay > policy.deadline_s):
                break
            if policy.on_wait is not None:
                policy.on_wait(delay)
            policy.sleep(delay)
            delay *= policy.backoff
    assert last is not None
    raise last
