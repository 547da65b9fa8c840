"""Deterministic sparse-field vocabulary layouts for the recsys configs.

Criteo-like field cardinalities span 10^1..10^7 with a heavy tail; the CTR
configs here (xDeepFM / AutoInt / BST) use a fixed power-law layout so every
run (tests, benches, dry-run) sees identical table geometry.
"""
from __future__ import annotations


def powerlaw_vocabs(n_fields: int, *, largest: int, smallest: int = 16,
                    n_large: int = 4) -> tuple[int, ...]:
    """``n_large`` hot fields at ``largest`` rows, rest geometric down to
    ``smallest``.  Deterministic; no RNG."""
    sizes = [largest] * n_large
    rest = n_fields - n_large
    if rest > 0:
        ratio = (smallest / largest) ** (1.0 / max(rest - 1, 1))
        val = largest * ratio
        for _ in range(rest):
            sizes.append(max(int(val), smallest))
            val *= ratio
    return tuple(sizes[:n_fields])


# 39 sparse fields, 4 x 10M hot fields, ~45.6M total rows.
CRITEO39 = powerlaw_vocabs(39, largest=10_000_000, smallest=16, n_large=4)

assert len(CRITEO39) == 39
