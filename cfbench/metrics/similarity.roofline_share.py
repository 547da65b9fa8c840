"""Percent of the bf16 compute bound the ``similarity`` kernel reaches in
a build: 2 n^2 m operations at 989e12 FLOP/s
(``cfbench.roofline.build_bound_s``) over the mean device seconds of the
``kernel.similarity`` spans of each build that ended before the profiler
started.  None where a build launched no kernel (the CPU)."""
from cfbench.metrics._spans import window_entries
from cfbench.roofline import build_bound_s


def read(records):
    entries = window_entries(records, "build", "cf.build_step")
    if not entries:
        return None
    ns = []
    for e in entries:
        d = e.device_ns_of("kernel.similarity")
        if not e.rows("kernel.similarity") or not d:
            return None
        ns.append(d)
    return 100.0 * build_bound_s(records["n"], records["m"]) / (
        sum(ns) / len(ns) * 1e-9)
