"""Percent of the traced slice of a ``read`` window in which no operation
ran on the device (1 - union of device intervals / wall)."""
from cfbench.trace import idle_share


def read(records):
    if records.get("kind") != "read":
        return None
    return idle_share(records)
