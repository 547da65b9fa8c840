"""Row sharding of the CF arena (PyTorch port of the CF part of
``repro.distributed.sharding``).

PyTorch has no meshes or ``PartitionSpec``s, so ``cf_shardings`` names,
for each leaf of a CF step's inputs, which rows rank ``r`` of a
``world_size``-rank process group holds: ``Rows`` (an even row slice) or
``Replicated`` (every row).  ``local_state`` cuts a rank's ``CFState`` by
that rule.  An arena whose rows the world size does not divide is refused:
the reference's ``rows_loc = N_base // n_shards`` would drop the last rows,
and ``shard_map`` refuses such a split.

``recsys_shardings`` names the same for the recsys family: the embedding
tables by rows, everything else replicated.  ``lm_shardings`` names it for
the LM family: tokens and the decode cache by batch rows, the params
replicated.  ``gnn_shardings`` names it for the GNN family: node, edge and
batch rows split, the params replicated.

``shard_row_slice`` is the fault harness's split, where the last shard
takes any remainder.  The mesh-only names of the reference module
(``MeshAxes``, ``named``, ``zero_extend``, ``mesh_axes``) come with the
dry-run group that uses them.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.types import CFState
from repro_torch.models import transformer as lm
from repro_torch.tree import tree_map


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
    [r·n/w, (r+1)·n/w) of axis ``axis`` (the LM decode cache keeps its
    batch rows on axis 1)."""

    world_size: int
    axis: int = 0

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


# The recsys family's embedding tables (``models.recsys``).  Each has at
# least 2**16 rows in every registered config, the reference's threshold
# for row sharding, and its rows are padded to 512 (``pad_to_shard``).
RECSYS_TABLES = ("table", "lin_table", "item_table", "other_table",
                 "user_table", "field_table")
# The recsys inputs; each splits by rows of the batch.
_RECSYS_INPUTS = ("sparse_idx", "dense", "multi_idx", "multi_mask", "hist",
                  "target", "label", "user_id", "user_fields", "item_id",
                  "item_fields")


def recsys_shardings(cfg, world_size: int, kind: str, params) -> dict:
    """Which rows of each leaf a rank holds for the recsys step ``kind``:
    ``{"params": <params' structure>, "inputs": {name: rule}}``.

    Params: the embedding tables (``RECSYS_TABLES``) by even row slices,
    every other leaf replicated.  Inputs: by rows of the batch; for the
    two-tower ``retrieval`` kind the candidates (``cand_ids``,
    ``cand_fields``) by rows and the user replicated.  ``cfg`` is a
    ``RecsysConfig``; ``params`` may hold ``meta`` tensors."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    rows = Rows(world_size)
    spec = {k: (tree_map(lambda _: rows, v) if k in RECSYS_TABLES
                else tree_map(lambda _: Replicated(), v))
            for k, v in params.items()}
    if cfg.variant == "two_tower" and kind == "retrieval":
        inputs = {"user_id": Replicated(), "user_fields": Replicated(),
                  "cand_ids": rows, "cand_fields": rows}
    else:
        inputs = {k: rows for k in _RECSYS_INPUTS}
    return {"params": spec, "inputs": inputs}


def lm_shardings(cfg, world_size: int, kind: str, batch: int,
                 seq_len: int) -> dict:
    """Which rows of each leaf a rank holds for the LM step ``kind``
    (``train``, ``prefill`` or ``decode``): ``{"params", "hooks",
    "inputs"}``, plus ``"cache"`` (prefill's output) and ``"logits"``
    (decode's output).

    Tokens, logits and the decode cache go by batch rows when
    ``world_size`` divides ``batch`` and are replicated otherwise, the
    reference's rule for its data axes; the cache's batch is its axis 1, and
    ``ring_pos`` is replicated.  The params are replicated: the reference's
    Megatron tensor-parallel and FSDP specs need a 2-D mesh, which waits for
    ``launch/mesh.py`` (ROADMAP Queue 1, item 4.4).  The hooks are the
    transformer's no-op ``LMShardingHooks()``.  ``seq_len`` sizes the
    cache."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    b = Rows(world_size) if batch % world_size == 0 else Replicated()
    cb = Rows(world_size, axis=1) if batch % world_size == 0 else Replicated()
    out = {"params": tree_map(lambda _: Replicated(), lm.param_structs(cfg)),
           "hooks": lm.LMShardingHooks()}
    cache = {k: Replicated() if k == "ring_pos" else cb
             for k in lm.cache_structs(cfg, batch, seq_len)}
    if kind == "train":
        out["inputs"] = {"tokens": b}
    elif kind == "prefill":
        out["inputs"] = {"tokens": b}
        out["cache"] = cache
    elif kind == "decode":
        out["inputs"] = {"cache": cache, "tokens": b, "pos": Replicated()}
        out["logits"] = b
    else:
        raise ValueError(f"unknown LM step kind {kind!r}; have 'train', "
                         "'prefill', 'decode'")
    return out


def gnn_shardings(cfg, world_size: int, kind: str) -> dict:
    """Which rows of each leaf a rank holds for the GNN step ``kind``
    (``train_full``, ``train_sampled`` or ``train_batched``):
    ``{"params", "inputs"}``.

    The params are replicated.  Every input splits by rows (axis 0) where
    the reference's spec puts the data axes or all axes there: the node
    tensors and the edge lists of ``train_full``, the feature store and the
    sampled block of ``train_sampled``, the graphs of ``train_batched``.
    ``cfg`` (a ``GNNConfig``) is taken for the reference's signature; no
    rule reads it."""
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    rows = Rows(world_size)
    params = {layer: {k: Replicated() for k in ("W", "a_src", "a_dst")}
              for layer in ("l1", "l2")}
    names = {"train_full": ("feats", "edge_src", "edge_dst", "labels",
                            "mask"),
             "train_sampled": ("feats", "roots", "nbr1", "nbr2", "labels"),
             "train_batched": ("feats", "edge_src", "edge_dst", "labels")}
    if kind not in names:
        raise ValueError(f"unknown GNN step kind {kind!r}; have "
                         f"{', '.join(map(repr, names))}")
    return {"params": params, "inputs": {k: rows for k in names[kind]}}
