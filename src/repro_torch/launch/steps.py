"""Cell builder (PyTorch port of ``repro.launch.steps``): (arch spec,
shape, world size) -> step function with its arguments as ``meta``
tensors, each leaf's row split over the ranks, and the analytic useful
FLOPs.  The single dispatch point the trainer shares with the tests.

Train cells run the full train step: loss -> backward -> AdamW update.
The port builds cells for all four families (``lm``, ``gnn``, ``recsys``,
``cf``).
``jit_cell`` and ``launch/mesh.py`` bind a cell to a TPU mesh; they wait
with the dry-run group (``dryrun``, ``roofline``) that ports them as
shape and memory checks on the ``meta`` device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.base import ArchSpec, ShapeSpec
from repro_torch.core.types import CFState
from repro_torch.distributed import sharding as shd
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
    shardings: Any                   # Rows/Replicated trees matching args
    model_flops: float               # analytic useful FLOPs, whole step


def _opt_structs_and_specs(param_structs, param_specs):
    opt = AdamW(lr=3e-4, weight_decay=0.01)
    opt_structs = opt.init(param_structs)
    opt_specs = AdamWState(step=shd.Replicated(), mu=param_specs,
                           nu=param_specs, master=param_specs)
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

def _lm_cell(spec: ArchSpec, shape: ShapeSpec, world_size: int) -> Cell:
    """``train``: ``lm_loss`` -> gradients -> AdamW.  ``prefill``: the
    last-position logits and the decode cache.  ``decode``: one token per
    sequence against the cache, which it updates in place."""
    cfg = spec.config
    sh = shd.lm_shardings(cfg, world_size, shape.kind,
                          shape.dim("global_batch"), shape.dim("seq_len"))
    pstructs = lm_mod.param_structs(cfg)
    pspecs, hooks = sh["params"], sh["hooks"]
    inputs = lm_mod.input_structs(cfg, shape)
    flops = lm_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "train":
        opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs)
        step = _train_step(
            lambda p, b: lm_mod.lm_loss(p, b["tokens"], cfg, hooks), opt)
        return Cell(name=name, fn=step, args=(pstructs, ostructs, inputs),
                    shardings=(pspecs, ospecs, sh["inputs"]),
                    model_flops=flops)
    if shape.kind == "prefill":
        def step(params, batch):
            return lm_mod.prefill(params, batch["tokens"], cfg, hooks)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    shardings=(pspecs, sh["inputs"]), model_flops=flops)

    def step(params, cache, tokens, pos):
        return lm_mod.decode_step(params, cache, tokens, pos, cfg, hooks)
    ins = sh["inputs"]
    return Cell(name=name, fn=step,
                args=(pstructs, inputs["cache"], inputs["tokens"],
                      inputs["pos"]),
                shardings=(pspecs, ins["cache"], ins["tokens"], ins["pos"]),
                model_flops=flops)


def _gnn_cell(spec: ArchSpec, shape: ShapeSpec, world_size: int) -> Cell:
    """An AdamW train step of the shape's loss.  ``train_full`` runs the
    edge-parallel GAT (``models.gnn_ep``) on the current process group:
    each rank passes its rows of the edge lists and the node tensors whole
    (every rank computes the loss from the replicated logits, so labels
    and mask are replicated too, where the reference's data axes split the
    loss).  The other kinds run whole on one rank; their shardings say
    which rows a rank would hold."""
    cfg = spec.config
    sh = shd.gnn_shardings(cfg, world_size, shape.kind)
    d = shape.dim("d_feat")
    n_out = {"full_graph_sm": 7, "minibatch_lg": 41, "ogb_products": 47,
             "molecule": 2}.get(shape.name, cfg.n_classes)
    pstructs = gnn_mod.init_params(None, cfg, d, n_out, device="meta")
    pspecs = sh["params"]
    inputs = gnn_mod.input_structs(cfg, shape)
    if shape.kind == "train_full":
        for k in ("feats", "labels", "mask"):
            sh["inputs"][k] = shd.Replicated()
        info = GNNEPInfo()
        loss = lambda p, b: loss_full_ep(p, b, cfg, info)   # noqa: E731
    else:
        kind_loss = gnn_mod.LOSS_BY_KIND[shape.kind]
        loss = lambda p, b: kind_loss(p, b, cfg)            # noqa: E731
    opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs)
    return Cell(name=f"{spec.arch_id}/{shape.name}",
                fn=_train_step(loss, opt), args=(pstructs, ostructs, inputs),
                shardings=(pspecs, ospecs, sh["inputs"]),
                model_flops=gnn_model_flops(cfg, shape))


def _recsys_cell(spec: ArchSpec, shape: ShapeSpec, world_size: int) -> Cell:
    cfg = spec.config
    pstructs = rec_mod.init_params(None, cfg, device="meta")
    sh = shd.recsys_shardings(cfg, world_size, shape.kind, pstructs)
    pspecs = sh["params"]
    inputs = rec_mod.input_structs(cfg, shape)
    in_specs = {k: sh["inputs"][k] for k in inputs}
    flops = recsys_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"

    if shape.kind == "train":
        opt, ostructs, ospecs = _opt_structs_and_specs(pstructs, pspecs)
        step = _train_step(lambda p, b: rec_mod.loss(p, b, cfg), opt)
        return Cell(name=name, fn=step, args=(pstructs, ostructs, inputs),
                    shardings=(pspecs, ospecs, in_specs), model_flops=flops)
    if shape.kind == "retrieval" and cfg.variant == "two_tower":
        def step(params, batch):
            return rec_mod.retrieve(params, batch, cfg)
        return Cell(name=name, fn=step, args=(pstructs, inputs),
                    shardings=(pspecs, in_specs), model_flops=flops)

    def step(params, batch):
        return rec_mod.forward(params, batch, cfg)
    return Cell(name=name, fn=step, args=(pstructs, inputs),
                shardings=(pspecs, in_specs), model_flops=flops)


def _cf_cell(spec: ArchSpec, shape: ShapeSpec, world_size: int) -> Cell:
    """``build``: ``models.cf.build_step``.  ``onboard``: the sharded burst
    (``onboard_step(distributed=True)``, as the reference's cell always
    takes the mesh path): it runs inside a ``torch.distributed`` process
    group of ``world_size`` ranks, each passing its rows of the arena
    (``distributed.sharding.local_state``)."""
    cfg = spec.config
    sh = shd.cf_shardings(cfg, world_size, shape.kind)
    inputs = cf_mod.input_structs(cfg, shape)
    flops = cf_model_flops(cfg, shape)
    name = f"{spec.arch_id}/{shape.name}"
    if shape.kind == "build":
        return Cell(name=name, fn=cf_mod.build_step, args=(inputs["R"],),
                    shardings=(sh["inputs"]["R"],), model_flops=flops)

    def step(state: CFState, R_new, probes):
        return cf_mod.onboard_step(state, R_new, probes, cfg,
                                   distributed=True)
    return Cell(name=name, fn=step,
                args=(inputs["state"], inputs["R_new"], inputs["probes"]),
                shardings=(sh["inputs"]["state"], sh["inputs"]["R_new"],
                           sh["inputs"]["probes"]),
                model_flops=flops)


_BUILDERS = {"lm": _lm_cell, "gnn": _gnn_cell, "recsys": _recsys_cell,
             "cf": _cf_cell}


def build_cell(spec: ArchSpec, shape: ShapeSpec, world_size: int = 1
               ) -> Cell:
    """The cell of ``spec`` at ``shape`` over ``world_size`` ranks."""
    return _BUILDERS[spec.family](spec, shape, world_size)

