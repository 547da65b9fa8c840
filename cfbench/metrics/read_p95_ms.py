"""95th percentile milliseconds over every read due in the window, each
from its due time to the return of ``CFServer.recommend_batch``."""
from cfbench.bench import percentile


def read(records):
    if records.get("kind") != "read":
        return None
    return percentile([(r["end"] - r["due"]) * 1e3
                       for r in records["requests"]], 95)
