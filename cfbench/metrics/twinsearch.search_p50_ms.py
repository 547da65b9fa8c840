"""Median milliseconds of TwinSearch's search in an onboard: the host
time of its ``twinsearch.search`` spans (probe similarities, candidate
mask and verification, up to the found flag's read), over the window's
onboards that searched, due before the profiler started."""
from cfbench.bench import percentile
from cfbench.metrics._spans import window_entries


def read(records):
    entries = window_entries(records, "onboard", "cf_server.onboard_user")
    if entries is None:
        return None
    return percentile([e.host_ns_of("twinsearch.search") * 1e-6
                       for e in entries if e.rows("twinsearch.search")], 50)
