"""95th percentile of each onboard's wait in the queue: from its due time
to the start of its call."""
from cfbench.bench import percentile, untraced


def read(records):
    if records.get("kind") != "onboard":
        return None
    return percentile([(r["start"] - r["due"]) * 1e3
                       for r in untraced(records)], 95)
