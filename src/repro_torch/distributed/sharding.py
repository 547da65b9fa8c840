"""Row sharding of the CF arena (PyTorch port of the CF part of
``repro.distributed.sharding``).

PyTorch has no meshes or ``PartitionSpec``s, so ``cf_shardings`` names,
for each leaf of a CF step's inputs, which rows rank ``r`` of a
``world_size``-rank process group holds: ``Rows`` (an even row slice) or
``Replicated`` (every row).  ``local_state`` cuts a rank's ``CFState`` by
that rule.  An arena whose rows the world size does not divide is refused:
the reference's ``rows_loc = N_base // n_shards`` would drop the last rows,
and ``shard_map`` refuses such a split.

``shard_row_slice`` is the fault harness's split, where the last shard
takes any remainder.  The mesh-only names of the reference module
(``MeshAxes``, ``named``, ``zero_extend``, the LM, GNN and recsys rules)
come with the models that use them.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import CFState


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


@dataclass(frozen=True)
class Rows:
    """Even row slices: rank r of ``world_size`` holds rows
    [r·n/w, (r+1)·n/w)."""

    world_size: int

    def slice(self, n_rows: int, rank: int) -> slice:
        w = self.world_size
        if not 0 <= rank < w:
            raise ValueError(f"rank {rank} outside [0, {w})")
        if n_rows % w:
            raise ValueError(f"{n_rows} rows do not split evenly over "
                             f"{w} ranks; pad the arena (configs.base."
                             f"pad_to_shard) to a multiple of {w}")
        per = n_rows // w
        return slice(rank * per, (rank + 1) * per)


@dataclass(frozen=True)
class Replicated:
    """Every rank holds every row."""

    def slice(self, n_rows: int, rank: int) -> slice:
        return slice(0, n_rows)


def cf_shardings(cfg, world_size: int, kind: str) -> dict:
    """Which rows of each leaf a rank holds, for the CF step ``kind``.

    ``build``: the ratings and both output lists by even row slices.
    ``onboard``: the arena's four arrays by even row slices, ``n_active``,
    the burst ``R_new`` and its ``probes`` replicated.  ``cfg`` (a
    ``CFConfig``) is taken for the reference's signature; no CF rule reads
    it."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    rows = Rows(world_size)
    if kind == "build":
        return {"inputs": {"R": rows}, "out": (rows, rows)}
    if kind == "onboard":
        return {"inputs": {
            "state": CFState(ratings=rows, norms=rows, sim_vals=rows,
                             sim_idx=rows, n_active=Replicated()),
            "R_new": Replicated(),
            "probes": Replicated(),
        }}
    raise ValueError(f"unknown CF step kind {kind!r}; have 'build', "
                     "'onboard'")


def local_state(state: CFState, rank: int, world_size: int) -> CFState:
    """Rank ``rank``'s rows of the arena under the ``onboard`` rule: views
    of its row slice of ``ratings``, ``norms``, ``sim_vals`` and
    ``sim_idx`` (each list keeps its full width, one entry per arena row),
    and ``n_active`` counted in the slice's own rows."""
    sl = Rows(world_size).slice(state.capacity, rank)
    n_loc = min(max(state.n_active - sl.start, 0), sl.stop - sl.start)
    return CFState(ratings=state.ratings[sl], norms=state.norms[sl],
                   sim_vals=state.sim_vals[sl], sim_idx=state.sim_idx[sl],
                   n_active=n_loc)
