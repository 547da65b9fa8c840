"""Median of the server's own time of each read call in the window
(``ServerStats.query_ms[-1]`` after each call)."""
from cfbench.bench import percentile, untraced


def read(records):
    if records.get("kind") != "read":
        return None
    return percentile([r["result"]["query_ms"] for r in untraced(records)],
                      50)
