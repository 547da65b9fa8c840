"""Straggler detection + elastic-restart policy.

On real fleets the failure modes are: a host dies (step hangs), a host slows
(step-time tail inflates), or a pod link degrades.  The monitor tracks
per-step wall times, flags stragglers by quantile ratio, and decides among
CONTINUE / CHECKPOINT_AND_SHRINK / ABORT.  The training launcher consults it
every step; on SHRINK it checkpoints (mesh-shape-agnostic, see
``checkpoint.py``) and re-launches with a smaller data axis — the sharding
rules are written against axis roles so no model code changes.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

log = logging.getLogger(__name__)


class Action(Enum):
    CONTINUE = "continue"
    CHECKPOINT_AND_SHRINK = "checkpoint_and_shrink"
    ABORT = "abort"


@dataclass
class StragglerMonitor:
    window: int = 50
    straggler_ratio: float = 2.5       # p99/p50 step-time ratio threshold
    hang_timeout_s: float = 300.0
    consecutive_to_shrink: int = 3
    clock: Callable[[], float] = time.monotonic   # injectable for tests
    _times: list[float] = field(default_factory=list)
    _flags: int = 0
    _last_start: float | None = None

    def step_started(self) -> None:
        self._last_start = self.clock()

    def step_finished(self) -> Action:
        if self._last_start is None:
            # A finish with no matching start (caller skipped step_started,
            # or a double-finish) carries no timing signal; dropping the
            # sample beats crashing the step loop it is meant to protect.
            log.warning("step_finished() without step_started(); "
                        "sample dropped")
            return Action.CONTINUE
        dt = self.clock() - self._last_start
        self._last_start = None
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        return self._evaluate(dt)

    def hung(self) -> bool:
        return (self._last_start is not None and
                self.clock() - self._last_start > self.hang_timeout_s)

    def _evaluate(self, dt: float) -> Action:
        if len(self._times) < max(10, self.window // 5):
            return Action.CONTINUE
        xs = sorted(self._times)
        p50 = xs[len(xs) // 2]
        p99 = xs[min(len(xs) - 1, int(len(xs) * 0.99))]
        if dt > self.hang_timeout_s:
            return Action.ABORT
        # The *current* step counts as a straggler when it exceeds the
        # windowed median by the configured ratio.
        if p50 > 0 and dt > self.straggler_ratio * p50:
            self._flags += 1
            if self._flags >= self.consecutive_to_shrink:
                self._flags = 0
                return Action.CHECKPOINT_AND_SHRINK
        else:
            self._flags = 0
        return Action.CONTINUE

    def stats(self) -> dict:
        if not self._times:
            return {}
        xs = sorted(self._times)
        return {
            "n": len(xs),
            "p50_s": xs[len(xs) // 2],
            "p90_s": xs[min(len(xs) - 1, int(len(xs) * 0.9))],
            "p99_s": xs[min(len(xs) - 1, int(len(xs) * 0.99))],
            "max_s": xs[-1],
        }


def shrink_mesh_shape(shape: tuple[int, ...], lost_fraction: float = 0.5
                      ) -> tuple[int, ...]:
    """Halve the leading (data) axis — the elastic fallback layout.  Model
    sharding is untouched so checkpoints reshard without repartitioning the
    network."""
    lead = max(1, shape[0] // 2)
    return (lead,) + tuple(shape[1:])
