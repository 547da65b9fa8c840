"""Percent of the traced slice of a burst window in which no operation ran
on the device (1 - union of device intervals / wall)."""
from cfbench.metrics._burst import bursts
from cfbench.trace import idle_share


def read(records):
    if bursts(records) is None:
        return None
    return idle_share(records)
