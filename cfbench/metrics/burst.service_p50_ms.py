"""Median milliseconds of the program's own time for a burst: the host
time of its ``cf.onboard_step`` request (the whole step, ending in the
sort's enqueue), over the window's bursts due before the profiler
started."""
from cfbench.bench import percentile
from cfbench.metrics._burst import window_entries


def read(records):
    entries = window_entries(records)
    if not entries:
        return None
    return percentile([e.host_ns * 1e-6 for e in entries], 50)
