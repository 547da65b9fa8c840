"""Median of the server's own service time of each onboard in the window
(``OnboardResult.latency_ms``: the compute step, after a sync; no
queueing, guard, rotation, health check or snapshot)."""
from cfbench.bench import percentile, untraced


def read(records):
    if records.get("kind") != "onboard":
        return None
    return percentile([r["result"]["latency_ms"] for r in untraced(records)
                       if r["result"]["status"] == "ok"], 50)
