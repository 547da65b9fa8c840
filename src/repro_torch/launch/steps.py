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
through the sharded burst, each over the mesh's ranks.  (``jit_cell``, the
reference's binding of a cell to a compiled program, waits with the dry
run.)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.types import CFState
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
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
                    model_flops=flops)
    if shape.kind == "prefill":
        def step(params, batch):
            return lm_mod.prefill(params, batch["tokens"], cfg, hooks)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    in_specs=(pspecs, sh["inputs"]),
                    out_specs=(P(ax.dp, ax.mp), sh["cache"]), donate=(),
                    model_flops=flops)

    def step(params, cache, tokens, pos):
        return lm_mod.decode_step(params, cache, tokens, pos, cfg, hooks)
    ins = sh["inputs"]
    return Cell(name=name, fn=step,
                args=(pstructs, inputs["cache"], inputs["tokens"],
                      inputs["pos"]),
                in_specs=(pspecs, ins["cache"], ins["tokens"], ins["pos"]),
                out_specs=(sh["logits"], ins["cache"]), donate=(1,),
                model_flops=flops)


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
                model_flops=gnn_model_flops(cfg, shape))


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
                    model_flops=flops)
    if shape.kind == "retrieval" and cfg.variant == "two_tower":
        def step(params, batch):
            return rec_mod.retrieve(params, batch, cfg)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    in_specs=(pspecs, in_specs), out_specs=None, donate=(),
                    model_flops=flops)

    def step(params, batch):
        return rec_mod.forward(params, batch, cfg)
    return Cell(name=name, fn=step, args=(pstructs, inputs),
                in_specs=(pspecs, in_specs), out_specs=None, donate=(),
                model_flops=flops)


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
                    donate=(), model_flops=flops)

    def step(state: CFState, R_new, probes):
        return cf_mod.onboard_step(state, R_new, probes, cfg,
                                   mesh_info=(ax.all, mesh))
    return Cell(name=name, fn=step,
                args=(inputs["state"], inputs["R_new"], inputs["probes"]),
                in_specs=(sh["inputs"]["state"], sh["inputs"]["R_new"],
                          sh["inputs"]["probes"]),
                out_specs=None, donate=(), model_flops=flops)


_BUILDERS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "cf": _cf_cell}


def build_cell(spec: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    """The cell of ``spec`` at ``shape`` on ``mesh`` (a ``DeviceMesh``,
    ``launch.mesh``)."""
    return _BUILDERS[spec.family](spec, shape, shd.mesh_axes(mesh), mesh)
