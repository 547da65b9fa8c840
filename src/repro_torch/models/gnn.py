"""GAT message passing (arXiv:1710.10903) in PyTorch segment ops (port of
``repro.models.gnn``).

Message passing is built from gathers and index reductions: SDDMM-style
edge scores -> segment-softmax over destination nodes (``index_reduce``
"amax" and ``index_add``) -> weighted scatter aggregation.  Three
execution regimes, matching the assigned shapes:

  * full-graph (Cora / ogbn-products): flat edge lists, segment ops over
    all nodes (the ``train_full`` cells run the edge-parallel form in
    ``models.gnn_ep``);
  * sampled minibatch (Reddit-scale): GraphSAGE-style fanout arrays; GAT
    attention runs densely over the (node, fanout) axis, only gathers from
    the feature store;
  * batched small graphs (molecule): graphs flattened block-diagonally with
    a graph-id readout.

Plain functions on tensors, in the reference's order of operations.  An
empty segment's max is -inf and maps to 0, as ``jax.ops.segment_max``
followed by the reference's ``where``; the gradient through the max stays
attached, as in the reference (it sums to zero analytically).  Index
reductions want int64 indices: the entry points cast the int32 edge lists
once (``.long()``), and a layer called with int64 lists copies nothing.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig, ShapeSpec, pad_to_shard
from repro_torch.models.layers import fan_in_init, leaky_relu, normal_init


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, seg, num_segments=n)``."""
    return x.new_zeros((n, *x.shape[1:])).index_add(0, seg, x)


def segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_max(x, seg, num_segments=n)``: -inf where a
    segment is empty (the output starts at -inf and the start value takes
    no part in the max)."""
    start = x.new_full((n, *x.shape[1:]), float("-inf"))
    return start.index_reduce(0, seg, x, "amax", include_self=False)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator | None, cfg: GNNConfig, d_feat: int,
                n_out: int | None = None,
                device: str | torch.device | None = None) -> dict:
    """2-layer GAT: d_feat -> (H x d_hidden, concat, ELU) -> n_classes.
    Seeded random weights from ``gen`` on ``device`` (the generator's by
    default); on the ``meta`` device nothing is drawn and ``gen`` may be
    None."""
    device = torch.device(device if device is not None else gen.device)
    dt = getattr(torch, cfg.dtype)
    H, Fh = cfg.n_heads, cfg.d_hidden
    n_out = n_out or cfg.n_classes

    def normal(shape, scale):
        return normal_init(gen, shape, scale, dt, device)

    def layer(d_in, f):
        return {"W": fan_in_init(gen, (d_in, H * f), dt, device),
                "a_src": normal((H, f), f ** -0.5),
                "a_dst": normal((H, f), f ** -0.5)}

    return {"l1": layer(d_feat, Fh), "l2": layer(H * Fh, n_out)}


# ---------------------------------------------------------------------------
# Segment-op GAT layer (full-graph / block-diagonal regimes)
# ---------------------------------------------------------------------------

def node_scores(x: torch.Tensor, lp: dict, n_heads: int
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The node projection ``Wh`` (N, H, F') and its two attention terms
    ``e_src``, ``e_dst`` (N, H)."""
    N = x.shape[0]
    Wh = torch.matmul(x, lp["W"].to(x.dtype)).reshape(N, n_heads, -1)
    e_src = torch.einsum("nhf,hf->nh", Wh, lp["a_src"].to(x.dtype))
    e_dst = torch.einsum("nhf,hf->nh", Wh, lp["a_dst"].to(x.dtype))
    return Wh, e_src, e_dst


def gat_layer_segment(x: torch.Tensor, edge_src: torch.Tensor,
                      edge_dst: torch.Tensor, lp: dict, n_heads: int, *,
                      negative_slope: float = 0.2, concat: bool = True
                      ) -> torch.Tensor:
    """x: (N, F_in); edges j->i as (src=j, dst=i).  Self-loops are the
    caller's responsibility (the data pipeline adds them)."""
    N = x.shape[0]
    src, dst = edge_src.long(), edge_dst.long()
    Wh, e_src, e_dst = node_scores(x, lp, n_heads)
    e = leaky_relu(e_src.index_select(0, src) + e_dst.index_select(0, dst),
                   negative_slope)                       # (E, H)
    e = e.float()
    m = segment_max(e, dst, N)
    m = torch.where(torch.isfinite(m), m, 0.0)
    ex = torch.exp(e - m.index_select(0, dst))
    denom = segment_sum(ex, dst, N)
    alpha = (ex / torch.clamp_min(denom.index_select(0, dst), 1e-16)
             ).to(x.dtype)
    msgs = Wh.index_select(0, src) * alpha[..., None]    # (E, H, F')
    out = segment_sum(msgs, dst, N)
    if concat:
        return out.reshape(N, -1)
    return torch.mean(out, dim=1)


def forward_segment(params: dict, feats: torch.Tensor,
                    edge_src: torch.Tensor, edge_dst: torch.Tensor,
                    cfg: GNNConfig) -> torch.Tensor:
    """(N, d_feat) -> (N, n_classes) logits via 2 GAT layers."""
    src, dst = edge_src.long(), edge_dst.long()
    h = gat_layer_segment(feats, src, dst, params["l1"], cfg.n_heads,
                          negative_slope=cfg.negative_slope)
    h = F.elu(h)
    return gat_layer_segment(h, src, dst, params["l2"], cfg.n_heads,
                             negative_slope=cfg.negative_slope, concat=False)


# ---------------------------------------------------------------------------
# Dense-fanout GAT layer (sampled-minibatch regime)
# ---------------------------------------------------------------------------

def gat_layer_fanout(x_self: torch.Tensor, x_nbrs: torch.Tensor, lp: dict,
                     n_heads: int, *, negative_slope: float = 0.2,
                     concat: bool = True) -> torch.Tensor:
    """Attention over a fixed sampled neighbourhood (+ self-loop).

    x_self: (B, F_in); x_nbrs: (B, K, F_in)."""
    B, K, _ = x_nbrs.shape
    xs = torch.cat([x_self[:, None], x_nbrs], dim=1)    # (B, 1+K, F)
    Wh = torch.matmul(xs, lp["W"].to(xs.dtype)).reshape(B, 1 + K, n_heads,
                                                         -1)
    e_src = torch.einsum("bkhf,hf->bkh", Wh, lp["a_src"].to(xs.dtype))
    e_dst = torch.einsum("bhf,hf->bh", Wh[:, 0], lp["a_dst"].to(xs.dtype))
    e = leaky_relu(e_src + e_dst[:, None], negative_slope)
    alpha = torch.softmax(e.float(), dim=1).to(xs.dtype)
    out = torch.einsum("bkh,bkhf->bhf", alpha, Wh)
    if concat:
        return out.reshape(B, -1)
    return torch.mean(out, dim=1)


def forward_sampled(params: dict, feats: torch.Tensor, roots: torch.Tensor,
                    nbr1: torch.Tensor, nbr2: torch.Tensor, cfg: GNNConfig
                    ) -> torch.Tensor:
    """2-layer GAT over a GraphSAGE-sampled block.

    feats: (N, d_feat) feature store; roots: (B,); nbr1: (B, f1) level-1
    neighbours; nbr2: (B·(1+f1), f2) level-2 neighbours of [roots ++
    flattened nbr1]."""
    B, f1 = nbr1.shape
    frontier = torch.cat([roots[:, None], nbr1], dim=1).reshape(-1)
    x_front = feats.index_select(0, frontier.long())  # (B(1+f1), F)
    x_n2 = feats.index_select(0, nbr2.reshape(-1).long()).reshape(
        *nbr2.shape, -1)                                 # (B(1+f1), f2, F)
    h1 = F.elu(gat_layer_fanout(x_front, x_n2, params["l1"], cfg.n_heads,
                                negative_slope=cfg.negative_slope))
    h1 = h1.reshape(B, 1 + f1, -1)
    return gat_layer_fanout(h1[:, 0], h1[:, 1:], params["l2"], cfg.n_heads,
                            negative_slope=cfg.negative_slope, concat=False)


# ---------------------------------------------------------------------------
# Losses / readouts
# ---------------------------------------------------------------------------

def node_xent(logits: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    m = mask.float()
    return -torch.sum(gold * m) / torch.clamp_min(torch.sum(m), 1.0)


def graph_readout(node_logits: torch.Tensor, graph_ids: torch.Tensor,
                  n_graphs: int) -> torch.Tensor:
    """Mean-pool node logits per graph (block-diagonal molecule batch)."""
    gids = graph_ids.long()
    s = segment_sum(node_logits.float(), gids, n_graphs)
    c = segment_sum(node_logits.new_ones(node_logits.shape[0],
                                         dtype=torch.float32), gids,
                    n_graphs)
    return s / torch.clamp_min(c[:, None], 1.0)


# ---------------------------------------------------------------------------
# Per-shape loss entry points + step inputs
# ---------------------------------------------------------------------------

def loss_full(params, batch, cfg: GNNConfig) -> torch.Tensor:
    logits = forward_segment(params, batch["feats"], batch["edge_src"],
                             batch["edge_dst"], cfg)
    return node_xent(logits, batch["labels"], batch["mask"])


def loss_sampled(params, batch, cfg: GNNConfig) -> torch.Tensor:
    logits = forward_sampled(params, batch["feats"], batch["roots"],
                             batch["nbr1"], batch["nbr2"], cfg)
    return node_xent(logits, batch["labels"],
                     logits.new_ones(logits.shape[0], dtype=torch.float32))


def loss_batched(params, batch, cfg: GNNConfig) -> torch.Tensor:
    """Block-diagonal molecule batch: graph classification."""
    feats = batch["feats"]                               # (B, n, F)
    B, n, Fd = feats.shape
    flat = feats.reshape(B * n, Fd)
    offs = (torch.arange(B, device=feats.device) * n)[:, None]
    src = (batch["edge_src"].long() + offs).reshape(-1)
    dst = (batch["edge_dst"].long() + offs).reshape(-1)
    logits = forward_segment(params, flat, src, dst, cfg)
    gids = torch.arange(B, device=feats.device).repeat_interleave(n)
    glogits = graph_readout(logits, gids, B)
    return node_xent(glogits, batch["labels"],
                     glogits.new_ones(B, dtype=torch.float32))


LOSS_BY_KIND = {
    "train_full": loss_full,
    "train_sampled": loss_sampled,
    "train_batched": loss_batched,
}


def input_structs(cfg: GNNConfig, shape: ShapeSpec) -> dict[str, Any]:
    """A step's inputs as ``meta`` tensors (shapes and dtypes, no data)."""
    f32, i32 = torch.float32, torch.int32

    def meta(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    d = shape.dim("d_feat")
    if shape.kind == "train_full":
        # Node/edge counts pad to the shard boundary; padding edges are
        # self-loops on the dead tail nodes (mask excludes them from loss).
        N = pad_to_shard(shape.dim("n_nodes"))
        E = pad_to_shard(shape.dim("n_edges") + shape.dim("n_nodes"))
        return {
            "feats": meta((N, d), f32),
            "edge_src": meta((E,), i32),
            "edge_dst": meta((E,), i32),
            "labels": meta((N,), i32),
            "mask": meta((N,), torch.bool),
        }
    if shape.kind == "train_sampled":
        N = pad_to_shard(shape.dim("n_nodes"))
        B = shape.dim("batch_nodes")
        f1, f2 = shape.dim("fanout")
        return {
            "feats": meta((N, d), f32),
            "roots": meta((B,), i32),
            "nbr1": meta((B, f1), i32),
            "nbr2": meta((B * (1 + f1), f2), i32),
            "labels": meta((B,), i32),
        }
    if shape.kind == "train_batched":
        B = shape.dim("batch")
        n, e = shape.dim("n_nodes"), shape.dim("n_edges")
        return {
            "feats": meta((B, n, d), f32),
            "edge_src": meta((B, e + n), i32),
            "edge_dst": meta((B, e + n), i32),
            "labels": meta((B,), i32),
        }
    raise ValueError(f"unknown GNN shape kind {shape.kind}")
