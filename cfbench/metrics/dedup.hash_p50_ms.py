"""Median milliseconds a read call spends hashing its dedup keys: the
host time of its ``dedup.hash`` span (``dedup_rows``), over the window's
calls due before the profiler started."""
from cfbench.bench import percentile
from cfbench.metrics._spans import window_entries


def read(records):
    entries = window_entries(records, "read", "cf_server.recommend_batch")
    if entries is None:
        return None
    return percentile([e.host_ns_of("dedup.hash") * 1e-6
                       for e in entries if e.rows("dedup.hash")], 50)
