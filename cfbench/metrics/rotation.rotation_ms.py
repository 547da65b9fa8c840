"""Mean milliseconds of the window's synchronous rotations
(``ServerStats.rotation_ms[-1]`` after each result that rotated)."""
from cfbench.bench import untraced


def read(records):
    if records.get("kind") != "onboard":
        return None
    ms = [r["result"]["rotation_ms"] for r in untraced(records)
          if r["result"]["rotation_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
