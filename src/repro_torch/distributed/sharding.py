"""Per-family sharding rules (PyTorch port of
``repro.distributed.sharding``).

Every rule is written against axis *roles*, not literal mesh shapes:
``dp`` = the data-parallel axes (('pod','data') on the multi-pod mesh,
('data',) on one pod), ``mp`` = the model/tensor axis, ``all`` = every axis.
The rules return trees of the port's ``P`` (a tuple of axis names, ``None``
or tuples of names, one entry per tensor dimension), tuple-equal to the
reference's ``PartitionSpec`` trees.

``named(mesh, specs)`` binds a spec tree to a ``DeviceMesh``
(``launch.mesh``): each ``NamedSharding`` leaf gives the shard shape and
the slices rank r holds.  A dimension named by several axes is split with
the first axis major, as JAX splits it, so rank r holds exactly what JAX
device r holds on the same mesh.  (DTensor placements shard a tensor
dimension in mesh-dimension order instead: the same shapes, other rows.)

The port's own row helpers stay beside the rules: ``shard_row_slice`` (the
fault harness's split, where the last shard takes any remainder), ``Rows``
(an even row split that refuses a remainder) and ``local_state``, which cuts
a rank's rows of the CF arena for the sharded burst.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.types import CFState
from repro_torch.models import transformer as lm
from repro_torch.models.moe_ep import MoEEPInfo
from repro_torch.tree import is_namedtuple, tree_map


class P(tuple):
    """A partition spec: one entry per tensor dimension, each an axis
    name, a tuple of axis names (split first-axis-major) or None
    (unsplit); trailing dimensions not listed are unsplit.  As JAX's
    ``PartitionSpec``, a one-name tuple is stored as the name and an empty
    one as None."""

    def __new__(cls, *parts):
        return super().__new__(cls, (_normal(p) for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


def _normal(part):
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        return None if not part else part[0] if len(part) == 1 else part
    return part


def _axes_of(part) -> tuple[str, ...]:
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


def map_specs(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to every ``P`` leaf of ``tree`` (and the matching
    leaves of ``rest``); containers as ``tree.tree_map`` walks them."""
    if tree is None:
        return None
    if isinstance(tree, P):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_specs(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(map_specs(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


@dataclass(frozen=True)
class MeshAxes:
    dp: tuple[str, ...]          # data-parallel axes
    mp: str                      # model/tensor axis
    sizes: dict[str, int]

    @property
    def all(self) -> tuple[str, ...]:
        return self.dp + (self.mp,)

    @property
    def mp_size(self) -> int:
        return self.sizes[self.mp]

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp:
            n *= self.sizes[a]
        return n


def mesh_axes(mesh) -> MeshAxes:
    """The roles of a ``DeviceMesh``'s axes: the last is ``model``, the
    others are data axes."""
    names = tuple(mesh.mesh_dim_names)
    if names[-1] != "model":
        raise ValueError(f"the mesh's last axis must be 'model': {names}")
    sizes = dict(zip(names, tuple(mesh.mesh.shape)))
    return MeshAxes(dp=names[:-1], mp="model", sizes=sizes)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh: which block of a global tensor each rank
    holds."""

    mesh: Any
    spec: P

    def _parts(self, ndim: int) -> list[tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than "
                             f"{ndim} dimensions")
        return [_axes_of(p) for p in self.spec] + [()] * (ndim -
                                                          len(self.spec))

    def _sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names,
                        tuple(self.mesh.mesh.shape)))

    def shard_shape(self, global_shape, pad: bool = False
                    ) -> tuple[int, ...]:
        """The shape of every rank's block; a dimension its axes do not
        divide raises, as JAX's ``shard_shape`` does, or with ``pad`` takes
        the larger block, as the padded shard XLA gives an uneven sharding
        (the dry run's counts)."""
        sizes = self._sizes()
        out = []
        for n, axes in zip(global_shape, self._parts(len(global_shape))):
            split = 1
            for a in axes:
                split *= sizes[a]
            if n % split and not pad:
                raise ValueError(f"dimension {n} of {tuple(global_shape)} "
                                 f"does not split {split} ways ({self.spec})")
            out.append(-(-n // split))
        return tuple(out)

    @property
    def device(self) -> torch.device:
        """Where this rank's blocks live: the mesh's device type (the
        current card for ``cuda``)."""
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    def indices(self, global_shape, rank: int) -> tuple[slice, ...]:
        """The slices of a global tensor that ``rank`` holds: ``slice(None)``
        on an unsplit dimension, as JAX's ``devices_indices_map``."""
        sizes = self._sizes()
        where = (self.mesh.mesh == rank).nonzero()
        if where.shape[0] != 1:
            raise ValueError(f"rank {rank} is not on the mesh")
        coord = dict(zip(self.mesh.mesh_dim_names, where[0].tolist()))
        shard = self.shard_shape(global_shape)
        out = []
        for n, axes in zip(shard, self._parts(len(global_shape))):
            if not axes:
                out.append(slice(None))
                continue
            block = 0
            for a in axes:                       # first axis major
                block = block * sizes[a] + coord[a]
            out.append(slice(block * n, (block + 1) * n))
        return tuple(out)


def named(mesh, spec_tree):
    """``P`` tree -> ``NamedSharding`` tree on ``mesh``."""
    return map_specs(lambda s: NamedSharding(mesh, s), spec_tree)


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

FSDP_MIN_LEAF = 1 << 22       # leaves >= 4M elements also shard over dp


def _fsdp_axes(ax: MeshAxes, dim_size: int) -> tuple | str:
    """Extend the model axis with the largest dp-axis prefix that divides
    ``dim_size`` (minor-most dp axis first): maxtext-style
    ('tensor', 'fsdp') weight sharding on a dimension that is never the
    contraction of its product."""
    chosen: list = [ax.mp]
    prod = ax.mp_size
    for a in ax.dp[::-1]:
        if dim_size % (prod * ax.sizes[a]) == 0:
            chosen.append(a)
            prod *= ax.sizes[a]
    return tuple(chosen) if len(chosen) > 1 else ax.mp


def lm_param_specs(cfg, ax: MeshAxes, decode: bool = False) -> dict:
    """Megatron TP over ``model`` + FSDP: each weight's mp-sharded output
    dim extends over the dp axes where divisible.  ``decode=True`` switches
    to weight-stationary sharding: the dp axes go on a contraction dim
    instead (leaves of at least ``FSDP_MIN_LEAF`` elements), so no weight
    is gathered."""
    mp = ax.mp
    shard_kv = cfg.n_kv_heads % ax.mp_size == 0

    def fa(n):
        return _fsdp_axes(ax, n)

    layers: dict[str, P] = {
        "attn_norm": P(None, None),
        "mlp_norm": P(None, None),
        "wq": P(None, None, fa(cfg.q_dim)),
        "wk": P(None, None, fa(cfg.kv_dim)) if shard_kv
        else P(None, None, None),
        "wv": P(None, None, fa(cfg.kv_dim)) if shard_kv
        else P(None, None, None),
        "wo": P(None, fa(cfg.q_dim), None),
    }
    gf = 2 if cfg.act in ("swiglu", "geglu") else 1
    if cfg.moe is not None:
        m = cfg.moe
        if m.n_experts % ax.mp_size == 0:
            # Experts over mp; the output dim (f for w_in, d for w_out)
            # takes the dp/FSDP axes.
            espec_in = zero_extend(P(None, mp, None, None),
                                   (1, m.n_experts, cfg.d_model,
                                    gf * m.d_ff_expert), ax, start=3)
            espec_out = zero_extend(P(None, mp, None, None),
                                    (1, m.n_experts, m.d_ff_expert,
                                     cfg.d_model), ax, start=3)
        else:
            espec_in = P(None, None, None, fa(gf * m.d_ff_expert))
            espec_out = P(None, None, fa(m.d_ff_expert), None)
        layers.update({"router": P(None, None, None), "w_in_e": espec_in,
                       "w_out_e": espec_out})
        if m.n_shared:
            layers["w_in_sh"] = P(None, None,
                                  fa(gf * m.n_shared * m.d_ff_expert))
            layers["w_out_sh"] = P(None, fa(m.n_shared * m.d_ff_expert),
                                   None)
    else:
        layers["w_in"] = P(None, None, fa(gf * cfg.d_ff))
        layers["w_out"] = P(None, fa(cfg.d_ff), None)
    specs = {"embed": P(mp, None), "layers": layers, "final_norm": P(None)}
    if not cfg.tie_embeddings:
        specs["unembed"] = P(None, mp)
    if decode:
        structs = lm.param_structs(cfg)["layers"]

        def strip(p):
            """Drop the dp axes of one entry, keeping mp or None."""
            if isinstance(p, tuple):
                kept = [a for a in p if a not in ax.dp]
                return kept[0] if len(kept) == 1 else (
                    tuple(kept) if kept else None)
            return None if p in ax.dp else p

        def stationary(spec, struct):
            base = P(*[strip(p) for p in spec])
            if struct.numel() >= FSDP_MIN_LEAF:
                return zero_extend(base, tuple(struct.shape), ax, start=1)
            return base

        specs["layers"] = {k: stationary(v, structs[k])
                           for k, v in layers.items()}
    return specs


def lm_hooks(cfg, ax: MeshAxes) -> lm.LMShardingHooks:
    seq = ax.mp if cfg.seq_shard else None
    moe_tok = moe_exp = None
    if cfg.moe is not None:
        moe_tok = P(ax.dp, None, None)
        moe_exp = (P(ax.dp, ax.mp, None, None)
                   if cfg.moe.n_experts % ax.mp_size == 0 else None)
    return lm.LMShardingHooks(acts=P(ax.dp, seq, None),
                              logits=P(ax.dp, None, ax.mp),
                              moe_tokens=moe_tok, moe_experts=moe_exp)


def lm_batch_specs(ax: MeshAxes) -> dict:
    return {"tokens": P(ax.dp, None)}


def lm_cache_specs(cfg, ax: MeshAxes, batch: int, seq_len: int) -> dict:
    """Decode cache: batch over dp when it divides; heads over mp when they
    divide; otherwise (MQA / small GQA / batch=1 long-context) the sequence
    axis takes the leftover axes (a flash-decoding split)."""
    mp = ax.mp
    heads_ok = cfg.n_kv_heads % ax.mp_size == 0
    b_ok = batch % ax.dp_size == 0

    def seq_axes(length: int, avail: tuple):
        """Largest prefix of ``avail`` whose product divides ``length``."""
        chosen: list = []
        prod = 1
        for a in avail:
            if length % (prod * ax.sizes[a]) == 0:
                chosen.append(a)
                prod *= ax.sizes[a]
        return tuple(chosen) if chosen else None

    def cache_spec(length: int) -> P:
        if b_ok and heads_ok:
            return P(None, ax.dp, None, mp, None)
        if b_ok:
            return P(None, ax.dp, seq_axes(length, (mp,)), None, None)
        if heads_ok:
            return P(None, None, seq_axes(length, ax.dp), mp, None)
        return P(None, None, seq_axes(length, ax.dp + (mp,)), None, None)

    specs = {}
    if cfg.window is None or cfg.global_every is not None:
        full = cache_spec(seq_len)
        specs["kg"] = full
        specs["vg"] = full
    if cfg.window is not None:
        ring = cache_spec(cfg.window)
        specs.update(kl=ring, vl=ring, ring_pos=P(None))
    return specs


def lm_shardings(cfg, ax: MeshAxes, kind: str, batch: int,
                 seq_len: int) -> dict:
    """``{"params", "hooks", "inputs"}`` for the LM step ``kind``
    (``train``, ``prefill`` or ``decode``), plus ``"cache"`` (prefill's
    output) and ``"logits"`` (decode's output).  The hooks carry a
    ``MoEEPInfo`` (expert parallelism, ``models.moe_ep``) whenever the
    experts divide the model axis and the kind is train or prefill; its
    ``mesh`` is bound by ``launch.steps``."""
    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown LM step kind {kind!r}; have 'train', "
                         "'prefill', 'decode'")
    params = lm_param_specs(cfg, ax, decode=(kind == "decode"))
    hooks = lm_hooks(cfg, ax)
    if (cfg.moe is not None and cfg.moe.n_experts % ax.mp_size == 0
            and kind in ("train", "prefill")):
        hooks = hooks._replace(moe_ep=MoEEPInfo(
            dp=ax.dp, mp=ax.mp, mp_size=ax.mp_size,
            win_spec=P(*params["layers"]["w_in_e"][1:]),
            wout_spec=P(*params["layers"]["w_out_e"][1:]),
            acts_spec=hooks.acts))
    out: dict[str, Any] = {"params": params, "hooks": hooks}
    b = ax.dp if batch % ax.dp_size == 0 else None
    if kind == "train":
        out["inputs"] = {"tokens": P(b, None)}
    elif kind == "prefill":
        out["inputs"] = {"tokens": P(b, None)}
        out["cache"] = lm_cache_specs(cfg, ax, batch, seq_len)
    else:
        out["inputs"] = {"cache": lm_cache_specs(cfg, ax, batch, seq_len),
                         "tokens": P(b, None), "pos": P()}
        out["logits"] = P(b, ax.mp)
    return out


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

_GNN_INPUTS = {"train_full": ("feats", "edge_src", "edge_dst", "labels",
                              "mask"),
               "train_sampled": ("feats", "roots", "nbr1", "nbr2", "labels"),
               "train_batched": ("feats", "edge_src", "edge_dst", "labels")}


def gnn_shardings(cfg, ax: MeshAxes, kind: str) -> dict:
    """``{"params", "inputs"}`` for the GNN step ``kind`` (``train_full``,
    ``train_sampled`` or ``train_batched``): the params replicated, the
    node, edge and graph rows split.  ``cfg`` (a ``GNNConfig``) is taken
    for the reference's signature; no rule reads it."""
    if kind not in _GNN_INPUTS:
        raise ValueError(f"unknown GNN step kind {kind!r}; have "
                         f"{', '.join(map(repr, _GNN_INPUTS))}")
    params = {layer: {k: P() for k in ("W", "a_src", "a_dst")}
              for layer in ("l1", "l2")}
    if kind == "train_full":
        inputs = {"feats": P(ax.dp, None), "edge_src": P(ax.all),
                  "edge_dst": P(ax.all), "labels": P(ax.dp),
                  "mask": P(ax.dp)}
    elif kind == "train_sampled":
        inputs = {"feats": P(ax.all, None),     # sharded feature store
                  "roots": P(ax.dp), "nbr1": P(ax.dp, None),
                  "nbr2": P(ax.dp, None), "labels": P(ax.dp)}
    else:
        inputs = {"feats": P(ax.dp, None, None), "edge_src": P(ax.dp, None),
                  "edge_dst": P(ax.dp, None), "labels": P(ax.dp)}
    return {"params": params, "inputs": inputs}


# ---------------------------------------------------------------------------
# Recsys
# ---------------------------------------------------------------------------

_RECSYS_INPUT_RANKS = {"sparse_idx": 2, "dense": 2, "multi_idx": 2,
                       "multi_mask": 2, "hist": 2, "target": 1, "label": 1,
                       "user_id": 1, "user_fields": 2, "item_id": 1,
                       "item_fields": 2}


def recsys_shardings(cfg, ax: MeshAxes, kind: str, params_struct) -> dict:
    """Tables (any leaf with >= 2**16 rows) shard rows over every axis;
    small dense params replicate.  Inputs split by batch rows over the data
    axes; two-tower ``retrieval`` splits its 10^6 candidates over the data
    axes and replicates the user.  ``params_struct`` may hold ``meta``
    tensors."""
    def rule(leaf):
        if leaf.ndim >= 1 and leaf.shape[0] >= (1 << 16):
            return P(ax.all, *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    params = tree_map(rule, params_struct)
    if cfg.variant == "two_tower" and kind == "retrieval":
        inputs = {"user_id": P(), "user_fields": P(None, None),
                  "cand_ids": P(ax.dp), "cand_fields": P(ax.dp, None)}
    else:
        inputs = {k: P(ax.dp, *([None] * (r - 1)))
                  for k, r in _RECSYS_INPUT_RANKS.items()}
    return {"params": params, "inputs": inputs}


# ---------------------------------------------------------------------------
# CF (the paper)
# ---------------------------------------------------------------------------

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


def cf_shardings(cfg, ax: MeshAxes, kind: str) -> dict:
    """``build``: the ratings over the data axes, the (dp, mp) similarity
    block, both output lists by rows over every axis.  ``onboard``: the
    arena's four arrays by rows over every axis, ``n_active``, the burst
    ``R_new`` and its ``probes`` replicated.  ``cfg`` (a ``CFConfig``) is
    taken for the reference's signature; no rule reads it."""
    rows_all = P(ax.all, None)
    if kind == "build":
        return {"inputs": {"R": P(ax.dp, None)}, "block": P(ax.dp, ax.mp),
                "rows": rows_all, "out": (rows_all, rows_all)}
    if kind == "onboard":
        return {"inputs": {
            "state": CFState(ratings=rows_all, norms=P(ax.all),
                             sim_vals=rows_all, sim_idx=rows_all,
                             n_active=P()),
            "R_new": P(None, None),
            "probes": P(None, None),
        }}
    raise ValueError(f"unknown CF step kind {kind!r}; have 'build', "
                     "'onboard'")


@dataclass(frozen=True)
class Rows:
    """Even row slices: rank r of ``world_size`` holds rows
    [r·n/w, (r+1)·n/w); a remainder is refused (the reference's
    ``rows_loc = N_base // n_shards`` would drop the last rows)."""

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


# ---------------------------------------------------------------------------
# Optimizer-state sharding (ZeRO-1-style extension)
# ---------------------------------------------------------------------------

def zero_extend(spec: P, shape: tuple[int, ...], ax: MeshAxes,
                start: int = 0) -> P:
    """Add dp sharding to the first unsharded, evenly-divisible axis (>=
    ``start``) of a leaf so Adam moments/master weights/FSDP params spread
    over the data axes instead of replicating.  No-op if any dp axis is
    already used (e.g. embedding tables row-sharded over every axis)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    used = {a for p in parts for a in _axes_of(p)}
    if used & set(ax.dp):
        return P(*parts)
    dp_n = ax.dp_size
    for i, (p, s) in enumerate(zip(parts, shape)):
        if i >= start and p is None and s % dp_n == 0 and s >= dp_n:
            parts[i] = ax.dp
            return P(*parts)
    return P(*parts)
