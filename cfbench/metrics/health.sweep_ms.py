"""Mean milliseconds of a health sweep: the ``cf_server.health`` spans
(``arena_healthy`` up to its ``bool()``, so their host time is the
sweep's) of the window's onboards due before the profiler started."""
from cfbench.metrics._spans import window_entries


def read(records):
    entries = window_entries(records, "onboard", "cf_server.onboard_user")
    if entries is None:
        return None
    ns = [c[3] - c[2] for e in entries for c in e.rows("cf_server.health")]
    return sum(ns) / len(ns) * 1e-6 if ns else None
