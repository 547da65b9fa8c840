"""Percent of the window's burst rows whose twin is an earlier row of
their own burst (``OnboardStats``: found, twin id at or past the base)."""
from cfbench.metrics._burst import bursts


def read(records):
    calls = bursts(records)
    rows = sum(b["rows"] for b in calls or ())
    if not rows:
        return None
    return 100.0 * sum(b["burst_twins"] for b in calls) / rows
