"""Median milliseconds of TwinSearch's search for one burst row: the host
time of each ``burst.search`` span (probe similarities, candidate mask
and bounded verify, as launched: the found flag is read after the
burst-internal equality and block sims are queued, outside the span),
over every row of the window's bursts due before the profiler started."""
from cfbench.bench import percentile
from cfbench.metrics._burst import window_entries


def read(records):
    entries = window_entries(records)
    if not entries:
        return None
    return percentile([(c[3] - c[2]) * 1e-6 for e in entries
                       for c in e.rows("burst.search")], 50)
