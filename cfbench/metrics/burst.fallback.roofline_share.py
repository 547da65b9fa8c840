"""Percent of the bandwidth bound a burst's fallback reaches: the least
time of its bytes (``cfbench.roofline_burst.fallback_bound_s``, the
arena's ratings and norms read once) over the mean device time of the
``burst.fallback`` spans of the window's bursts due before the profiler
started."""
from cfbench.metrics._burst import window_entries
from cfbench.roofline_burst import fallback_bound_s


def read(records):
    entries = window_entries(records)
    if not entries:
        return None
    dev = [c[4] for e in entries for c in e.rows("burst.fallback")]
    if not dev or any(d is None for d in dev):
        return None
    n, m = records["arena"]
    return 100.0 * fallback_bound_s(n, m) / (sum(dev) / len(dev) * 1e-9)
