"""The traced run: ``torch.profiler`` over a steady slice of the window,
reduced in memory (nothing is written to disk).

The drivers wrap each call into the program, and each wait for the next
arrival, in a ``record_function`` span named ``cfbench.<what>``; these
are the only spans (spans inside ``repro_torch`` are a later change).
From the device's operations the slice gives:

  busy_s      the union of the device's operation intervals in the slice
  window_s    the slice's length on the host clock
  device_ops  the operations that took most device time, by name
  idle_gaps   the longest intervals with no device operation, each named
              by the benchmark span the host was in at its middle
"""
from __future__ import annotations

import bisect
import contextlib
import time

import torch

OP_NAME_CHARS = 96


def _is_device(event) -> bool:
    return str(event.device_type()).endswith("CUDA")


class Tracer:
    """Starts the profiler ``start_s`` into the window (as the driver
    reports it through ``tick``) and stops it ``length_s`` later."""

    def __init__(self, enabled: bool, device, start_s: float = 0.0,
                 length_s: float = 0.0):
        self.enabled = enabled
        self.device = device
        self.start_s = start_s
        self.length_s = length_s
        self.prof = None
        self.t0_ns = self.t1_ns = 0
        self.done = False

    def _activities(self):
        from torch.profiler import ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up, so the start in the
        window does not pay the tracer's own initialisation."""
        if not self.enabled:
            return
        from torch.profiler import profile
        with profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            self._sync()

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def tick(self, elapsed_s: float) -> None:
        """Called by the driver between calls with the window's elapsed
        seconds; starts and stops the slice."""
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed_s >= self.start_s:
            from torch.profiler import profile
            self.prof = profile(activities=self._activities())
            self.prof.start()
            self.t0_ns = time.time_ns()
        elif self.prof is not None and (
                elapsed_s >= self.start_s + self.length_s):
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        self._sync()
        self.t1_ns = time.time_ns()
        self.prof.stop()
        self.done = True

    def summary(self) -> dict | None:
        """The slice reduced to busy time, top operations and idle gaps;
        None if no slice was traced."""
        if self.prof is None:
            return None
        self.stop()
        t0, t1 = self.t0_ns, self.t1_ns
        intervals, spans = [], []
        by_op: dict[str, float] = {}
        for e in self.prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if _is_device(e) and not e.name().startswith("cfbench."):
                # (a benchmark span also appears on the device's timeline
                # as an annotation over the whole call: not an operation)
                a, b = max(s, t0), min(s + d, t1)
                if b > a:
                    intervals.append((a, b))
                    key = e.name()[:OP_NAME_CHARS]
                    by_op[key] = by_op.get(key, 0.0) + (b - a) * 1e-9
            elif e.name().startswith("cfbench."):
                spans.append((s, s + d, e.name()))
        intervals.sort()
        merged: list[list[int]] = []
        for a, b in intervals:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_ns = sum(b - a for a, b in merged)
        edges = [t0] + [x for ab in merged for x in ab] + [t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans.sort()
        starts = [s for s, _, _ in spans]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            j = bisect.bisect_right(starts, mid) - 1
            name = "host.other"
            if j >= 0 and spans[j][1] >= mid:       # spans do not nest
                name = spans[j][2]
            named.append((name, (b - a) * 1e-9))
        idle_by_span: dict[str, float] = {}
        for name, sec in named:
            idle_by_span[name] = idle_by_span.get(name, 0.0) + sec
        named.sort(key=lambda x: -x[1])
        ops = sorted(by_op.items(), key=lambda x: -x[1])
        return {"busy_s": busy_ns * 1e-9, "window_s": (t1 - t0) * 1e-9,
                "device_ops": [[k, v] for k, v in ops[:10]],
                "idle_gaps": [[k, v] for k, v in named[:10]],
                "idle_by_span": idle_by_span,
                "device_op_count": len(intervals)}


def idle_share(records: dict) -> float | None:
    """The device's idle share of the traced slice, in percent."""
    tr = records.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["device_op_count"] == 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
