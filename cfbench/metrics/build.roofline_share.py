"""Percent of the bf16 compute bound a build reaches: 2 n^2 m operations
at 989e12 FLOP/s (``cfbench.roofline.build_bound_s``) over the measured
seconds per build, over the builds that ended before the profiler
started."""
from cfbench.roofline import build_bound_s


def read(records):
    if records.get("kind") != "build":
        return None
    start = records.get("traced_from_s")
    ends = [t for t in records["ends"] if start is None or t <= start]
    if not ends:
        return None
    return 100.0 * build_bound_s(records["n"], records["m"]) / (
        ends[-1] / len(ends))
