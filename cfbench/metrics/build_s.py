"""Seconds per build: the window's time over the number of back-to-back
``build_step`` calls completed in it."""
def read(records):
    if records.get("kind") != "build" or not records["builds"]:
        return None
    return records["window_s"] / records["builds"]
