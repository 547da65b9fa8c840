"""What the readers of the program's spans share: the window's calls,
paired with the entries of the program's span recorder
(``repro_torch.spans.RECORDER``).

The recorder is looked up among the modules the run has loaded, never
imported, so a reader imports nothing of the program; a program without
the recorder gives no entries, and its readers read nothing.

Nothing calls the program after the window, so the last entries of the
call's request name are the window's calls, in order.  The pairing is
refused (None) when the log holds fewer entries than the window had
calls (a log cut short, or its oldest entries dropped), or when an entry
does not lie inside its call, within 1 ms, at one offset between the two
clocks (the least offset of any pair): an entry longer than its call, or
a log shifted by a call made after the window.
"""
import sys

from cfbench.bench import untraced

SLACK_NS = 1_000_000


def recorder():
    """The program's span recorder, if the run loaded it."""
    mod = sys.modules.get("repro_torch.spans")
    return getattr(mod, "RECORDER", None)


def window_entries(records: dict, kind: str, request: str):
    """The recorder's ``request`` entries of the window's calls due before
    the profiler started (builds: ended before it started), oldest first;
    None where the records are not of ``kind`` or the pairing fails."""
    if records.get("kind") != kind:
        return None
    rec = recorder()
    if rec is None:
        return None
    if kind == "build":
        ends = list(records["ends"])
        starts = [0.0] + ends[:-1]
        start = records.get("traced_from_s")
        keep = [start is None or t <= start for t in ends]
    else:
        reqs = records["requests"]
        starts = [r["start"] for r in reqs]
        ends = [r["end"] for r in reqs]
        kept = {id(r) for r in untraced(records)}
        keep = [id(r) in kept for r in reqs]
    n = len(starts)
    entries = rec.entries(request)
    if n == 0 or len(entries) < n:
        return None
    entries = entries[-n:]
    starts = [round(s * 1e9) for s in starts]
    ends = [round(t * 1e9) for t in ends]
    offset = min(e.start - s for e, s in zip(entries, starts))
    if any(e.end - offset > t + SLACK_NS for e, t in zip(entries, ends)):
        return None
    return [e for e, k in zip(entries, keep) if k]
