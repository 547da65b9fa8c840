"""Percent of the window's read rows that twin dedup did not score
(1 - ``query_unique`` / ``queries``)."""
def read(records):
    if records.get("kind") != "read" or not records["stats"]["queries"]:
        return None
    s = records["stats"]
    return 100.0 * (1.0 - s["query_unique"] / s["queries"])
