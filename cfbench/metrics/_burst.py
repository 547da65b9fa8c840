"""What the readers of the burst cell share: its records hold one request
a burst row and, under ``bursts``, one entry a burst; the program's
``cf.onboard_step`` entries pair with the bursts as ``_spans`` pairs a
kind's calls, and only the bursts due before the profiler started are
kept."""
from cfbench.metrics import _spans


def bursts(records: dict):
    """The window's bursts, or None where the records are not a burst
    cell's."""
    if records.get("kind") != "onboard" or "bursts" not in records:
        return None
    return records["bursts"]


def window_entries(records: dict):
    """The recorder's ``cf.onboard_step`` entries of the window's bursts
    due before the profiler started, oldest first; None where the
    records are not a burst cell's or the pairing fails."""
    calls = bursts(records)
    if calls is None:
        return None
    return _spans.window_entries(
        {"kind": "onboard", "requests": calls,
         "traced_from_s": records.get("traced_from_s")},
        "onboard", "cf.onboard_step")
