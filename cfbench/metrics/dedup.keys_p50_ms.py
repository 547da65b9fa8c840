"""Median milliseconds a read call spends making its dedup keys: the host
time of its ``dedup.keys`` span (the copies of the top-k similarities,
neighbour ids and rating rows to the host, which wait for the device, and
their concatenation), over the window's calls due before the profiler
started."""
from cfbench.bench import percentile
from cfbench.metrics._spans import window_entries


def read(records):
    entries = window_entries(records, "read", "cf_server.recommend_batch")
    if entries is None:
        return None
    return percentile([e.host_ns_of("dedup.keys") * 1e-6
                       for e in entries if e.rows("dedup.keys")], 50)
