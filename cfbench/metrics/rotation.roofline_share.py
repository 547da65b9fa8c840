"""Percent of the bandwidth bound the window's rotations reach: the
least time of their bytes (``cfbench.roofline.rotation_bound_s``, the
old lists read once and the new written once) over their measured time."""
from cfbench.bench import untraced
from cfbench.roofline import rotation_bound_s


def read(records):
    if records.get("kind") != "onboard":
        return None
    rot = [r["result"] for r in untraced(records)
           if r["result"]["rotation_ms"] is not None]
    if not rot:
        return None
    bound = sum(rotation_bound_s(r["cap_before"], r["cap_after"])
                for r in rot)
    return 100.0 * bound / (sum(r["rotation_ms"] for r in rot) * 1e-3)
