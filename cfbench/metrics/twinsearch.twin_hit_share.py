"""Percent of the window's onboards served by a twin copy
(``ServerStats.twin_hits`` over ``onboarded``)."""
def read(records):
    if records.get("kind") != "onboard" or not records["stats"]["onboarded"]:
        return None
    s = records["stats"]
    return 100.0 * s["twin_hits"] / s["onboarded"]
