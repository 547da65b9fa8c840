"""The least work of a burst's fallback, kept with the benchmark so a
change to the program cannot change what its share is measured against.

The fallback (``cosine_vs_all`` over the arena) reads the (n, m) float32
ratings and the (n,) float32 norms once; the new row and the (n,) output
are counted too, though they are nothing beside the arena.
"""
from __future__ import annotations

from cfbench.roofline import HBM_BYTES_PER_S


def fallback_bytes(n: int, m: int) -> float:
    """Bytes of one fallback row over an arena of n rows and m columns."""
    return 4.0 * n * m + 4.0 * n + 4.0 * m + 4.0 * n


def fallback_bound_s(n: int, m: int) -> float:
    return fallback_bytes(n, m) / HBM_BYTES_PER_S
