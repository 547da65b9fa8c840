"""The open loop shared by the request-serving kinds.

Requests are due on a fixed schedule, whatever the server is doing; one
client thread sends each at its due time or, when the previous call ran
late, at once.  Each request is timed from its due time, so a stall
counts for every request queued behind it.  The generator's own
lateness (how far past a due time it woke when the server was idle) is
reported apart.
"""
from __future__ import annotations

import time

SPIN_S = 0.001      # sleep until this close to a due time, then spin


def wait_until(t: float) -> None:
    rest = t - time.perf_counter()
    if rest > SPIN_S:
        time.sleep(rest - SPIN_S)
    while time.perf_counter() < t:
        pass


def run(due_s, call, tracer, span: str) -> list[dict]:
    """Call ``call(i)`` for each due time (seconds from the window's
    start).  Returns, per request, its due, start and end times (seconds
    from the start), whether the client waited for it (the server was
    idle), and the call's result."""
    base = time.perf_counter()
    out = []
    for i, due in enumerate(due_s):
        now = time.perf_counter() - base
        tracer.tick(now)
        waited = now < due
        if waited:
            with tracer.span("cfbench.wait"):
                wait_until(base + due)
        start = time.perf_counter() - base
        with tracer.span(span):
            res = call(i)
        end = time.perf_counter() - base
        out.append({"due": due, "start": start, "end": end,
                    "waited": waited, "result": res})
    tracer.stop()
    return out


def queue_note(reqs: list[dict], service_ms) -> str:
    """The latency from due time to return, the server's own time and the
    queue's wait, for standard error."""
    from cfbench.bench import percentile
    wait = [(r["start"] - r["due"]) * 1e3 for r in reqs]
    lat = [(r["end"] - r["due"]) * 1e3 for r in reqs]
    return (f"latency p50 {percentile(lat, 50):.4f} ms p95 "
            f"{percentile(lat, 95):.4f} ms; "
            f"service p50 {percentile(service_ms, 50):.4f} ms p95 "
            f"{percentile(service_ms, 95):.4f} ms; wait p50 "
            f"{percentile(wait, 50):.4f} ms p95 {percentile(wait, 95):.4f} ms"
            f" over {len(reqs)} requests")


def lateness_note(reqs: list[dict]) -> str:
    """The generator's lateness over the requests it waited for."""
    late = [r["start"] - r["due"] for r in reqs if r["waited"]]
    if not late:
        return "open loop: the server was never idle at a due time"
    return (f"open loop: generator lateness over {len(late)} idle arrivals "
            f"mean {sum(late) / len(late) * 1e3:.4f} ms, max "
            f"{max(late) * 1e3:.4f} ms; last request ended "
            f"{reqs[-1]['end'] - reqs[-1]['due']:.4f} s after it was due")
