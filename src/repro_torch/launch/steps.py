"""Cell builder (PyTorch port of ``repro.launch.steps``): (arch spec,
shape, mesh) -> step function with its arguments as ``meta`` tensors, the
reference's partition specs for them (``distributed.sharding``; bind them
to the mesh with ``named``), and the analytic useful FLOPs.  The single
dispatch point the trainer shares with the tests.

Train cells run the full train step: loss -> backward -> AdamW update, the
optimizer state's specs ZeRO-extended over the data axes as in the
reference.  The port builds cells for all four families (``lm``, ``gnn``,
``recsys``, ``cf``).  A cell's function runs on this rank's tensors: the
LM train and prefill cells of an MoE whose experts divide the model axis
route through ``models.moe_ep`` on the mesh's process groups, the GNN
``train_full`` cell through ``models.gnn_ep`` and the CF onboard cell
through the sharded burst, each over the mesh's ranks.

``jit_cell(cell, mesh)`` binds a cell to a program, as the reference's
does.  Called, the program runs the step on this rank's tensors (the
trainer's path).  ``.lower(*cell.args).compile()`` traces it on ``meta``
tensors under the counters of ``launch.trace`` instead of compiling it (the
port runs eagerly and has no XLA), and the result answers the reference's
three questions: ``cost_analysis()``, ``memory_analysis()`` and
``as_text()`` (one HLO-style line per collective).  How each is counted per
device is stated on ``Compiled``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.types import CFState
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.launch import trace
from repro_torch.models import cf as cf_mod
from repro_torch.models import gnn as gnn_mod
from repro_torch.models.gnn_ep import GNNEPInfo, loss_full_ep
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as lm_mod
from repro_torch.training.optimizer import AdamW, AdamWState
from repro_torch.training.train_loop import value_and_grad


@dataclass
class Cell:
    name: str
    fn: Callable
    args: tuple                      # trees of ``meta`` tensors
    in_specs: Any                    # P trees (tuple matching args)
    out_specs: Any                   # or None for auto
    donate: tuple[int, ...]          # args the step may overwrite
    model_flops: float               # analytic useful FLOPs, whole step
    spec: ArchSpec                   # what it was built from, for
    shape: ShapeSpec                 # ``jit_cell``'s trace


def _opt_structs_and_specs(param_structs, param_specs, ax):
    opt = AdamW(lr=3e-4, weight_decay=0.01)
    opt_structs = opt.init(param_structs)

    def ext(spec, struct):
        return shd.zero_extend(spec, tuple(struct.shape), ax)

    ext_specs = shd.map_specs(ext, param_specs, param_structs)
    opt_specs = AdamWState(step=P(), mu=ext_specs, nu=ext_specs,
                           master=ext_specs)
    return opt, opt_structs, opt_specs


def _train_step(loss_fn, optimizer):
    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, loss
    return step


# ---------------------------------------------------------------------------
# Analytic useful-FLOPs models (global, whole step; coarse ±20%: a
# roofline's useful-fraction denominator, not a benchmark number).  The
# reference's arithmetic, unchanged.
# ---------------------------------------------------------------------------

def lm_model_flops(cfg, shape: ShapeSpec) -> float:
    N = cfg.active_param_count()
    B, S = shape.dim("global_batch"), shape.dim("seq_len")
    if shape.kind == "train":
        return 6.0 * N * B * S
    if shape.kind == "prefill":
        return 2.0 * N * B * S
    return 2.0 * N * B                   # decode: one token per sequence


def gnn_model_flops(cfg, shape: ShapeSpec) -> float:
    H, F = cfg.n_heads, cfg.d_hidden
    d = shape.dim("d_feat")
    C = cfg.n_classes
    if shape.kind == "train_full":
        N, E = shape.dim("n_nodes"), shape.dim("n_edges") + shape.dim(
            "n_nodes")
        fwd = 2 * N * d * H * F + 2 * N * H * F * H * C + \
            4 * E * H * (F + C)
        return 3.0 * fwd
    if shape.kind == "train_sampled":
        B = shape.dim("batch_nodes")
        f1, f2 = shape.dim("fanout")
        n1 = B * (1 + f1)
        fwd = 2 * n1 * (1 + f2) * d * H * F + 2 * B * (1 + f1) * H * F * \
            H * C
        return 3.0 * fwd
    Bt = shape.dim("batch")
    n, e = shape.dim("n_nodes"), shape.dim("n_edges") + shape.dim("n_nodes")
    fwd = Bt * (2 * n * d * H * F + 2 * n * H * F * H * C + 4 * e * H *
                (F + C))
    return 3.0 * fwd


def recsys_model_flops(cfg, shape: ShapeSpec) -> float:
    B = shape.dim("batch")
    if shape.kind == "retrieval":
        B = shape.dim("n_candidates")
    D, m = cfg.embed_dim, cfg.n_sparse
    if cfg.variant == "xdeepfm":
        cin = 0
        prev = m
        for h in cfg.cin_layers:
            cin += prev * m * D + 2 * prev * m * h * D
            prev = h
        dnn_in = m * D + cfg.n_dense
        dnn = 2 * (dnn_in * cfg.mlp_dims[0] +
                   sum(a * b for a, b in zip(cfg.mlp_dims,
                                             cfg.mlp_dims[1:])))
        fwd = B * (cin + dnn)
    elif cfg.variant == "autoint":
        T = m + cfg.n_dense
        A = cfg.d_attn
        per = 4 * T * D * A + 2 * T * T * A * 2
        fwd = B * (cfg.n_attn_layers * per + T * A * 2)
    elif cfg.variant == "bst":
        S = cfg.seq_len + 1
        attn = 4 * S * D * D + 4 * S * S * D + 8 * D * D * S
        flat = (S + m) * D
        mlp = 2 * (flat * cfg.mlp_dims[0] +
                   sum(a * b for a, b in zip(cfg.mlp_dims,
                                             cfg.mlp_dims[1:])))
        fwd = B * (attn + mlp)
    else:                                # two_tower
        dims = cfg.tower_mlp
        u_in, i_in = 128 + 4 * 32, 128 + 2 * 32
        tower = 2 * (u_in * dims[0] + i_in * dims[0] +
                     2 * sum(a * b for a, b in zip(dims, dims[1:])))
        fwd = B * tower
        if shape.kind == "train":
            fwd += 2 * B * B * dims[-1]
        if shape.kind == "retrieval":
            fwd += 2 * B * dims[-1]
    mult = 3.0 if shape.kind == "train" else 1.0
    return mult * fwd


def cf_model_flops(cfg, shape: ShapeSpec) -> float:
    n, m = shape.dim("n_users"), shape.dim("n_items")
    if shape.kind == "build":
        return 2.0 * n * n * m
    k = shape.dim("k_new")
    # Paper Sec 3.2: O((1 + (k-1)/125) * m * n) for the burst.
    return 2.0 * n * m * (1.0 + (k - 1) / cfg.set0_divisor)


# ---------------------------------------------------------------------------
# Family cell builders
# ---------------------------------------------------------------------------

def _lm_cell(spec: ArchSpec, shape: ShapeSpec, ax: shd.MeshAxes,
             mesh=None) -> Cell:
    """``train``: ``lm_loss`` -> gradients -> AdamW.  ``prefill``: the
    last-position logits and the decode cache.  ``decode``: one token per
    sequence against the cache, which it updates in place."""
    cfg = spec.config
    sh = shd.lm_shardings(cfg, ax, shape.kind, shape.dim("global_batch"),
                          shape.dim("seq_len"))
    if sh["hooks"].moe_ep is not None:
        sh["hooks"] = sh["hooks"]._replace(
            moe_ep=sh["hooks"].moe_ep._replace(mesh=mesh))
    pstructs = lm_mod.param_structs(cfg)
    pspecs, hooks = sh["params"], sh["hooks"]
    inputs = lm_mod.input_structs(cfg, shape)
    flops = lm_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "train":
        opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs, ax)
        step = _train_step(
            lambda p, b: lm_mod.lm_loss(p, b["tokens"], cfg, hooks), opt)
        return Cell(name=name, fn=step, args=(pstructs, ostructs, inputs),
                    in_specs=(pspecs, ospecs, sh["inputs"]),
                    out_specs=(pspecs, ospecs, P()), donate=(0, 1),
                    model_flops=flops, spec=spec, shape=shape)
    if shape.kind == "prefill":
        def step(params, batch):
            return lm_mod.prefill(params, batch["tokens"], cfg, hooks)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    in_specs=(pspecs, sh["inputs"]),
                    out_specs=(P(ax.dp, ax.mp), sh["cache"]), donate=(),
                    model_flops=flops, spec=spec, shape=shape)

    def step(params, cache, tokens, pos):
        return lm_mod.decode_step(params, cache, tokens, pos, cfg, hooks)
    ins = sh["inputs"]
    return Cell(name=name, fn=step,
                args=(pstructs, inputs["cache"], inputs["tokens"],
                      inputs["pos"]),
                in_specs=(pspecs, ins["cache"], ins["tokens"], ins["pos"]),
                out_specs=(sh["logits"], ins["cache"]), donate=(1,),
                model_flops=flops, spec=spec, shape=shape)


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, ax: shd.MeshAxes,
              mesh=None) -> Cell:
    """An AdamW train step of the shape's loss.  ``train_full`` runs the
    edge-parallel GAT (``models.gnn_ep``) over the mesh's ranks: each rank
    passes its rows of the edge lists and the node tensors whole (every
    rank computes the loss from the replicated logits, so labels and mask
    are replicated too, where the reference's data axes split the loss).
    The other kinds run whole on one rank; their specs say which rows a
    rank would hold."""
    cfg = spec.config
    sh = shd.gnn_shardings(cfg, ax, shape.kind)
    d = shape.dim("d_feat")
    n_out = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
             "molecule": 2}.get(shape.name, cfg.n_classes)
    pstructs = gnn_mod.init_params(None, cfg, d, n_out, device="meta")
    pspecs = sh["params"]
    inputs = gnn_mod.input_structs(cfg, shape)
    if shape.kind == "train_full":
        sh["inputs"].update(feats=P(None, None), labels=P(None),
                            mask=P(None))
        info = GNNEPInfo(axes=ax.all, mesh=mesh)
        loss = lambda p, b: loss_full_ep(p, b, cfg, info)   # noqa: E731
    else:
        kind_loss = gnn_mod.LOSS_BY_KIND[shape.kind]
        loss = lambda p, b: kind_loss(p, b, cfg)            # noqa: E731
    opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs, ax)
    return Cell(name=f"{spec.arch_id}/{shape.name}",
                fn=_train_step(loss, opt), args=(pstructs, ostructs, inputs),
                in_specs=(pspecs, ospecs, sh["inputs"]),
                out_specs=(pspecs, ospecs, P()), donate=(0, 1),
                model_flops=gnn_model_flops(cfg, shape), spec=spec,
                shape=shape)


def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, ax: shd.MeshAxes,
                 mesh=None) -> Cell:
    cfg = spec.config
    pstructs = rec_mod.init_params(None, cfg, device="meta")
    sh = shd.recsys_shardings(cfg, ax, shape.kind, pstructs)
    pspecs = sh["params"]
    inputs = rec_mod.input_structs(cfg, shape)
    in_specs = {k: sh["inputs"][k] for k in inputs}
    flops = recsys_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "train":
        opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs, ax)
        step = _train_step(lambda p, b: rec_mod.loss(p, b, cfg), opt)
        return Cell(name=name, fn=step, args=(pstructs, ostructs, inputs),
                    in_specs=(pspecs, ospecs, in_specs),
                    out_specs=(pspecs, ospecs, P()), donate=(0, 1),
                    model_flops=flops, spec=spec, shape=shape)
    if shape.kind == "retrieval" and cfg.variant == "two_tower":
        def step(params, batch):
            return rec_mod.retrieve(params, batch, cfg)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    in_specs=(pspecs, in_specs), out_specs=None, donate=(),
                    model_flops=flops, spec=spec, shape=shape)

    def step(params, batch):
        return rec_mod.forward(params, batch, cfg)
    return Cell(name=name, fn=step, args=(pstructs, inputs),
                in_specs=(pspecs, in_specs), out_specs=None, donate=(),
                model_flops=flops, spec=spec, shape=shape)


def _cf_cell(spec: ArchSpec, shape: ShapeSpec, ax: shd.MeshAxes,
             mesh=None) -> Cell:
    """``build``: ``models.cf.build_step``.  ``onboard``: the sharded burst
    over every axis of the mesh (``onboard_step(mesh_info=...)``, as the
    reference's cell always takes the mesh path): each rank passes its rows
    of the arena (``distributed.sharding.local_state``)."""
    cfg = spec.config
    sh = shd.cf_shardings(cfg, ax, shape.kind)
    inputs = cf_mod.input_structs(cfg, shape)
    flops = cf_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"
    if shape.kind == "build":
        return Cell(name=name, fn=cf_mod.build_step, args=(inputs["R"],),
                    in_specs=(sh["inputs"]["R"],), out_specs=sh["out"],
                    donate=(), model_flops=flops, spec=spec, shape=shape)

    def step(state: CFState, R_new, probes):
        return cf_mod.onboard_step(state, R_new, probes, cfg,
                                   mesh_info=(ax.all, mesh))
    return Cell(name=name, fn=step,
                args=(inputs["state"], inputs["R_new"], inputs["probes"]),
                in_specs=(sh["inputs"]["state"], sh["inputs"]["R_new"],
                          sh["inputs"]["probes"]),
                out_specs=None, donate=(), model_flops=flops, spec=spec,
                shape=shape)


_BUILDERS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "cf": _cf_cell}


def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    """The cell of ``spec`` at ``shape`` on ``mesh`` (a ``DeviceMesh``,
    ``launch.mesh``)."""
    return _BUILDERS[spec.family](spec, shape, shd.mesh_axes(mesh), mesh)


# ---------------------------------------------------------------------------
# jit_cell: the program of a cell, and its trace on ``meta``
# ---------------------------------------------------------------------------

class MemoryAnalysis(NamedTuple):
    """Bytes per device, under the reference's (XLA's) field names."""

    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int
    alias_size_in_bytes: int
    peak_memory_in_bytes: int


def _block(mesh, spec, shape) -> tuple[int, ...]:
    """One rank's block of a ``shape`` tensor under ``spec`` on ``mesh``,
    padded where the axes do not divide a dimension."""
    return shd.NamedSharding(mesh, spec).shard_shape(tuple(shape), pad=True)


def _tree_bytes(specs, tree, mesh) -> int:
    """Bytes of one rank's blocks of ``tree``'s tensors."""
    total = [0]

    def add(spec, leaf):
        if isinstance(leaf, torch.Tensor):
            total[0] += (math.prod(_block(mesh, spec, leaf.shape))
                         * leaf.element_size())
        return spec
    shd.map_specs(add, specs, tree)
    return total[0]


def _local(specs, tree, mesh):
    """``meta`` tensors of one rank's blocks of ``tree``'s leaves."""
    def block(spec, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        return torch.empty(_block(mesh, spec, leaf.shape), dtype=leaf.dtype,
                           device="meta")
    return shd.map_specs(block, specs, tree)


def _one_rank_mesh_of(mesh):
    """A (1, 1) mesh ("data", "model") over this rank alone, for the global
    trace: the card's layout, where every rank-local block is whole."""
    from torch.distributed.device_mesh import DeviceMesh
    if mesh.size() == 1:
        return mesh
    me = torch.distributed.get_rank()
    return DeviceMesh(mesh.device_type, torch.full((1, 1), me),
                      mesh_dim_names=("data", "model"))


def _replay_moe_ep(rec: trace.Collectives, cfg, shape: ShapeSpec, mesh,
                   info) -> None:
    """``moe_ffn_ep``'s collectives at this rank's shapes on ``mesh``
    (``info`` its ``MoEEPInfo``).  Every layer of an MoE model routes
    through it: one call with its backward stands for each layer of a
    train step, one forward for each layer's ``remat`` recompute, and one
    forward for each layer of a prefill."""
    from repro_torch.models.moe_ep import moe_ffn_ep
    B, S = shape.dim("global_batch"), shape.dim("seq_len")
    info = info._replace(mesh=mesh)
    layers = lm_mod.param_structs(cfg)["layers"]
    dt = layers["w_in_e"].dtype

    def meta(shape_, spec, grad):
        t = torch.empty(_block(mesh, spec, shape_), dtype=dt, device="meta")
        return t.requires_grad_(grad)

    def call(grad: bool) -> None:
        with torch.set_grad_enabled(grad):
            x = meta((B, S, cfg.d_model), info.acts_spec, grad)
            w_in = meta(tuple(layers["w_in_e"].shape[1:]), info.win_spec,
                        grad)
            w_out = meta(tuple(layers["w_out_e"].shape[1:]), info.wout_spec,
                         grad)
            router = meta(tuple(layers["router"].shape[1:]), P(), grad)
            y, aux = moe_ffn_ep(x, router, w_in, w_out, cfg.moe, cfg.act,
                                info)
            if grad:
                (y.float().sum() + aux).backward()

    train = shape.kind == "train"
    with rec.repeated(cfg.n_layers):
        call(train)
    if train and cfg.remat:
        with rec.repeated(cfg.n_layers):
            call(False)


def _derive_lm(rec: trace.Collectives, cfg, shape: ShapeSpec, mesh) -> None:
    """The collectives GSPMD inserts for the reference's LM specs, derived
    leaf by leaf from ``named(mesh, specs)`` by this rule (the port's LM
    runs whole on one rank, so nothing calls them):

      * FSDP (train, prefill): every weight split over data axes is
        all-gathered over them before each use: one all-gather of each
        layer's slice (its block with the data axes undone) per forward
        pass, the ``remat`` recompute and the backward included;
      * gradients (train): each weight's gradient is reduce-scattered over
        the data axes that split it, or all-reduced over all of them if
        none does, once per layer;
      * decode keeps its weights stationary (no gather); a weight split
        over data axes on its contraction dim sums its product's (B, 1,
        out) output over them with an all-reduce;
      * Megatron (all kinds): the attention block's and the MLP's outputs
        are partial sums over ``model``: one all-reduce each of the
        (B, S, d) activation block per layer and pass (an MoE layer routed
        through ``moe_ep`` has its own, explicit collectives instead of the
        MLP's), and one for the vocabulary-split embedding per forward.

    Expert weights routed through ``moe_ep`` are left out: its replay
    (``_replay_moe_ep``) counts their gathers and reduce-scatters."""
    ax = shd.mesh_axes(mesh)
    B, S = shape.dim("global_batch"), shape.dim("seq_len")
    kind = shape.kind
    sh = shd.lm_shardings(cfg, ax, kind, B, S)
    ep = sh["hooks"].moe_ep is not None
    structs = lm_mod.param_structs(cfg)
    L = cfg.n_layers
    n_fwd = 1 + int(kind == "train" and cfg.remat)
    n_pass = n_fwd + int(kind == "train")
    seq = 1 if kind == "decode" else S
    acts = _block(mesh, sh["hooks"].acts, (B, seq, cfg.d_model))

    def dp_axes(spec) -> tuple[str, ...]:
        return tuple(a for p in spec if p is not None
                     for a in (p if isinstance(p, tuple) else (p,))
                     if a in ax.dp)

    def strip(spec) -> P:
        return P(*[tuple(a for a in (p if isinstance(p, tuple) else (p,))
                         if a not in ax.dp) if p is not None else None
                   for p in spec])

    def leaf(name: str, spec, struct, per: int) -> None:
        dpa = dp_axes(spec)
        ndp = math.prod(ax.sizes[a] for a in dpa)
        local = _block(mesh, spec, struct.shape)
        dt = struct.dtype
        if kind != "decode" and dpa:
            rec.record("all-gather", _block(mesh, strip(spec), struct.shape),
                       dt, ndp, per * n_pass)
        if kind == "train":
            if dpa:
                rec.record("reduce-scatter", local, dt, ndp, per)
            else:
                rec.record("all-reduce", local, dt, ax.dp_size, per)
        if kind == "decode" and len(spec) >= 2 and any(
                a in dpa for a in (spec[-2] if isinstance(spec[-2], tuple)
                                   else (spec[-2],))):
            rec.record("all-reduce", (acts[0], 1, local[-1]), dt, ndp, per)

    for name, spec in sh["params"]["layers"].items():
        if ep and name in ("w_in_e", "w_out_e"):
            continue
        struct = structs["layers"][name]
        leaf(name, P(*spec[1:]), struct[0], L)
    for name in ("embed", "final_norm", "unembed"):
        if name in sh["params"]:
            leaf(name, sh["params"][name], structs[name], 1)
    dt = structs["embed"].dtype
    per_layer = 1 if ep else 2
    rec.record("all-reduce", acts, dt, ax.mp_size, L * per_layer * n_pass)
    rec.record("all-reduce", acts, dt, ax.mp_size, n_fwd)


def _per_rank(cell: Cell, mesh, args: tuple):
    """(collectives, counter, outputs) of this rank on ``mesh``.  The
    collectives are those of the sharded burst and ``gnn_ep``, recorded as
    this rank's program calls them on the ``"fake"`` backend (its trace's
    counter and outputs come back too), or for the LM cells those of
    ``moe_ep``, replayed, and those GSPMD would insert (``_derive_lm``).
    ``None`` for every other cell: its step runs whole on one rank and no
    rule derives what a partitioned program would exchange."""
    spec, shape = cell.spec, cell.shape
    rec = trace.Collectives()
    if spec.family == "lm":
        cfg = spec.config
        info = shd.lm_shardings(cfg, shd.mesh_axes(mesh), shape.kind,
                                shape.dim("global_batch"),
                                shape.dim("seq_len"))["hooks"].moe_ep
        with rec:
            if info is not None:
                _replay_moe_ep(rec, cfg, shape, mesh, info)
            _derive_lm(rec, cfg, shape, mesh)
        return rec, None, None
    if (spec.family, shape.kind) == ("cf", "onboard"):
        local = _local(cell.in_specs, args, mesh)
    elif (spec.family, shape.kind) == ("gnn", "train_full"):
        local = (*args[:2], _local(cell.in_specs[2], args[2], mesh))
    else:
        return None, None, None
    with rec, trace.Counter() as counter:
        out = cell.fn(*local)
    return rec, counter, out


class Compiled:
    """A cell's step counted on ``meta``, per device of the mesh:

      * ``cost_analysis()``: the step traced once at global shapes as the
        card runs it on a (1, 1) mesh (``launch.trace.Counter``), divided
        by the number of devices: the ideal partition, which understates
        work a partitioned program repeats on every device (replicated
        parameters and node tensors, gathered weights).  ``"flops f32"``
        is the part of ``"flops"`` in fp32.
      * ``memory_analysis()``: arguments exact, from the blocks
        ``named(mesh, cell.in_specs)`` gives; outputs from ``out_specs``
        (the global outputs divided by the devices where the cell has
        none); aliased bytes, the donated arguments'; temporaries, the
        trace's peak of live bytes less what it still holds at its end (its
        outputs), from this rank's own trace where the cell has a per-rank
        program (the sharded burst, ``gnn_ep``), else the global trace's
        divided by the devices (a lower estimate where work is
        replicated); peak, arguments + outputs + temporaries - aliased.
        Temporaries and peak are estimates.
      * ``as_text()``: the collectives (``launch.trace.Collectives``), one
        HLO-style line each.  ``collectives_counted`` is False where none
        are counted (``_per_rank``): the text is empty and the roofline's
        collective term is 0, which is no bound.

    ``kernels`` holds the hand-written kernels' global calls, FLOPs and
    bytes; ``seconds`` the trace's time."""

    def __init__(self, cost: dict, memory: MemoryAnalysis, text: str,
                 kernels: dict, seconds: float, collectives_counted: bool):
        self._cost, self._memory, self._text = cost, memory, text
        self.kernels, self.seconds = kernels, seconds
        self.collectives_counted = collectives_counted

    def cost_analysis(self) -> dict:
        return dict(self._cost)

    def memory_analysis(self) -> MemoryAnalysis:
        return self._memory

    def as_text(self) -> str:
        return self._text


def _trace_global(cell: Cell, mesh, args: tuple):
    """(counter, outputs) of the step at global shapes on a (1, 1) mesh."""
    spec, shape = cell.spec, cell.shape
    gcell = build_cell(spec, shape, _one_rank_mesh_of(mesh))
    if spec.family == "lm" and shape.kind == "decode":
        # The position is read on the host; ``meta`` holds no data, so the
        # trace writes the cache's last position.
        args = (*args[:3], shape.dim("seq_len") - 1)
    with trace.Counter() as counter:
        out = gcell.fn(*args)
    return counter, out


class Lowered:
    def __init__(self, cell: Cell, mesh, args: tuple):
        self.cell, self.mesh, self.args = cell, mesh, args

    def compile(self) -> Compiled:
        cell, mesh, args = self.cell, self.mesh, self.args
        t0 = time.perf_counter()
        n_dev = mesh.size()
        counter, out = _trace_global(cell, mesh, args)
        rec, local, local_out = trace.Collectives(), None, None
        if n_dev > 1:
            rec, local, local_out = _per_rank(cell, mesh, args)
        arg_b = _tree_bytes(cell.in_specs, args, mesh)
        if cell.out_specs is None:
            out_b = sum(map(trace.nbytes, trace.tensors(out))) // n_dev
        else:
            out_b = _tree_bytes(cell.out_specs, out, mesh)
        alias_b = sum(_tree_bytes(cell.in_specs[i], args[i], mesh)
                      for i in cell.donate)
        # Read while ``out`` and ``local_out`` are held: what a trace
        # created and still holds is its outputs.
        if local is not None:
            temp_b = local.peak - local.live
        else:
            temp_b = (counter.peak - counter.live) // n_dev
        memory = MemoryAnalysis(arg_b, out_b, temp_b, alias_b,
                                arg_b + out_b + temp_b - alias_b)
        cost = {"flops": (counter.flops + counter.flops_f32) / n_dev,
                "flops f32": counter.flops_f32 / n_dev,
                "bytes accessed": counter.bytes / n_dev}
        text = rec.hlo_text() if rec is not None else ""
        return Compiled(cost, memory, text, counter.kernels,
                        time.perf_counter() - t0,
                        collectives_counted=rec is not None)


class Program:
    """``jit_cell``'s program: called, it runs ``cell.fn`` on this rank's
    tensors; ``lower(*args).compile()`` counts it (``Compiled``)."""

    def __init__(self, cell: Cell, mesh):
        self.cell, self.mesh = cell, mesh

    def __call__(self, *args):
        return self.cell.fn(*args)

    def lower(self, *args) -> Lowered:
        return Lowered(self.cell, self.mesh, args)


def jit_cell(cell: Cell, mesh) -> Program:
    """The program of ``cell`` bound to ``mesh`` (a ``DeviceMesh``).  The
    reference's binds the specs as ``NamedSharding``s for XLA; here the
    specs bind when the program is counted, and running it is eager."""
    return Program(cell, mesh)
