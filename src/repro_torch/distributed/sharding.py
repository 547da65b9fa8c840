"""Row sharding of the CF arena (PyTorch port of the CF part of
``repro.distributed.sharding``).

Only ``shard_row_slice`` is here: the rest of the reference module
describes JAX meshes, and the sharded onboarding path decides what it
needs from it.
"""
from __future__ import annotations


def shard_row_slice(n_rows: int, n_shards: int, shard: int) -> slice:
    """Row range owned by ``shard`` under the even row-sharding every CF
    arena spec uses (``P(ax.all, None)``).  The serving fault harness keys
    on this to simulate shard loss: the rows a dead shard would stop
    serving are exactly this slice."""
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    per = n_rows // n_shards
    lo = shard * per
    hi = n_rows if shard == n_shards - 1 else lo + per
    return slice(lo, hi)
