"""Mean device milliseconds a rotation spends in its base rows' merges:
the summed device time of the ``rotation.merge`` spans (each chunk's
stable re-sort and ``list_merge``) of each of the window's onboards that
rotated, due before the profiler started."""
from cfbench.metrics._spans import window_entries


def read(records):
    entries = window_entries(records, "onboard", "cf_server.onboard_user")
    if entries is None:
        return None
    per = []
    for e in entries:
        if e.rows("rotation.merge"):
            ns = e.device_ns_of("rotation.merge")
            if ns is None:
                return None
            per.append(ns)
    return sum(per) / len(per) * 1e-6 if per else None
