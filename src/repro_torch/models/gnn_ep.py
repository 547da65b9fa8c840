"""Edge-parallel full-graph GAT on ``torch.distributed`` (port of
``repro.models.gnn_ep``).

Each rank of a process group holds the node features, labels and mask
whole (replicated) and its rows of the edge list.  Messages stay local
to their edge rows and node aggregates are combined with collectives:

  per rank:  e_loc = LeakyReLU(a_src·Wh[src_loc] + a_dst·Wh[dst_loc])
             m     = all_reduce MAX(segment_max(e_loc))          (N, H)
             Z     = all_reduce SUM(segment_sum(exp(e_loc − m)))  (N, H)
             out   = all_reduce SUM(segment_sum(alpha · Wh[src_loc]))

Node projections are computed replicated.  As in the reference, the max
carries no gradient (it only stabilises the softmax), an empty segment is
-1e30 before the MAX and 0 after it, and the message sum is float32.

**Gradients.**  Every rank computes the same loss from the replicated
logits, so a collective's backward must neither count that loss once per
rank nor lose another rank's share.  Two operators do it: a reduction of
rank-local partial sums (forward ``all_reduce`` SUM, backward the
identity: the cotangent of a replicated result is already whole on every
rank) and an entry into the rank-local computation of a replicated tensor
(forward the identity, backward ``all_reduce`` SUM of the ranks' partial
cotangents).  Each layer enters its input and its params; the softmax
denominator, read back by the local edges, takes both.  Every rank then
holds the whole gradient, and the optimizer sees identical gradients.

**Memory.**  One card may hold the whole edge list (ogbn-products: 64.3 M
edges, whose layer-2 messages (E, H, n_out) would take 96.7 GB).  The
gather-scale-scatter of the messages therefore runs in edge chunks of at
most ``MSG_CHUNK_BYTES`` (2 GiB) of messages, forward and backward
(``_MessageSum``, which saves only ``Wh``, ``alpha`` and the indices): the
reference's per-layer ``jax.checkpoint(..., nothing_saveable)`` at chunk
granularity.  The (E, H) score tensors (2.06 GB each there) are whole.
Chunking changes only the order of float sums.

Without an initialised process group the entry points raise; nothing
falls back to ``gnn.loss_full``.  ``GNNEPInfo`` names the edges' ranks as
the reference does, by mesh axes of a ``DeviceMesh`` (every axis when
``axes`` is None); without a mesh, the default process group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import GNNConfig
from repro_torch.launch.mesh import axis_group
from repro_torch.models.gnn import (node_scores, node_xent, segment_max,
                                    segment_sum)
from repro_torch.models.layers import leaky_relu

MSG_CHUNK_BYTES = 2 << 30


class GNNEPInfo(NamedTuple):
    axes: tuple[str, ...] | None = None   # mesh axes the edges split over
    mesh: object = None                   # their DeviceMesh

    def process_group(self):
        """The group the edges split over (None: the default group)."""
        return None if self.mesh is None else axis_group(self.mesh,
                                                          self.axes)


def edge_chunk(n_heads: int, f_out: int, dtype: torch.dtype) -> int:
    """Edges a chunk of the message sum holds: at most ``MSG_CHUNK_BYTES``
    of (chunk, n_heads, f_out) messages in ``dtype``."""
    row = n_heads * f_out * torch.empty((), dtype=dtype).element_size()
    return max(1, MSG_CHUNK_BYTES // row)


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "the edge-parallel GAT needs an initialised torch.distributed "
            "process group (init_process_group); it does not fall back to "
            "gnn.loss_full")


class _ReduceShards(torch.autograd.Function):
    """Sum of the ranks' partial results (in place); the backward passes
    the replicated cotangent to every rank's partial."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.mark_dirty(x)
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterShards(torch.autograd.Function):
    """A replicated tensor entering rank-local work; the backward sums the
    ranks' partial cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _MessageSum(torch.autograd.Function):
    """out[i] = Σ_{e: dst[e] = i} Wh[src[e]] · alpha[e], float32, in
    chunks of ``chunk`` edges; the backward recomputes the gathers chunk by
    chunk."""

    @staticmethod
    def forward(ctx, Wh, alpha, src, dst, chunk):
        out = torch.zeros(Wh.shape, dtype=torch.float32, device=Wh.device)
        for lo in range(0, src.numel(), chunk):
            hi = lo + chunk
            msgs = Wh.index_select(0, src[lo:hi]).mul_(alpha[lo:hi, :, None])
            out.index_add_(0, dst[lo:hi], msgs.float())
        ctx.save_for_backward(Wh, alpha, src, dst)
        ctx.chunk = chunk
        return out

    @staticmethod
    def backward(ctx, g):
        Wh, alpha, src, dst = ctx.saved_tensors
        need_wh, need_alpha = ctx.needs_input_grad[:2]
        g = g.to(Wh.dtype)
        d_wh = torch.zeros_like(Wh) if need_wh else None
        d_alpha = torch.empty_like(alpha) if need_alpha else None
        for lo in range(0, src.numel(), ctx.chunk):
            hi = lo + ctx.chunk
            ge = g.index_select(0, dst[lo:hi])           # (chunk, H, F')
            if need_alpha:
                d_alpha[lo:hi] = (ge * Wh.index_select(0, src[lo:hi])
                                  ).sum(-1)
            if need_wh:
                d_wh.index_add_(0, src[lo:hi], ge.mul_(alpha[lo:hi, :, None]))
        return d_wh, d_alpha, None, None, None


def _gat_layer_local(x, src, dst, lp, n_heads, negative_slope, concat,
                     group):
    N = x.shape[0]
    x = _EnterShards.apply(x, group)
    lp = {k: _EnterShards.apply(v, group) for k, v in lp.items()}
    Wh, e_src, e_dst = node_scores(x, lp, n_heads)
    e = leaky_relu(e_src.index_select(0, src) + e_dst.index_select(0, dst),
                   negative_slope)
    e = e.float()

    with torch.no_grad():
        m = segment_max(e, dst, N)
        m = torch.where(torch.isfinite(m), m, -1e30)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        m = torch.where(m > -1e29, m, 0.0)
    ex = torch.exp(e - m.index_select(0, dst))
    denom = _EnterShards.apply(
        _ReduceShards.apply(segment_sum(ex, dst, N), group), group)
    alpha = (ex / torch.clamp_min(denom.index_select(0, dst), 1e-16)
             ).to(x.dtype)
    chunk = edge_chunk(n_heads, Wh.shape[-1], Wh.dtype)
    out = _ReduceShards.apply(_MessageSum.apply(Wh, alpha, src, dst, chunk),
                              group).to(x.dtype)
    if concat:
        return out.reshape(N, -1)
    return torch.mean(out, dim=1)


def forward_segment_ep(params: dict, feats: torch.Tensor,
                       edge_src: torch.Tensor, edge_dst: torch.Tensor,
                       cfg: GNNConfig, info: GNNEPInfo) -> torch.Tensor:
    """(N, d) replicated feats + this rank's rows of the edge lists ->
    (N, n_classes) replicated logits."""
    _require_group()
    group = info.process_group()
    src, dst = edge_src.long(), edge_dst.long()
    h = F.elu(_gat_layer_local(feats, src, dst, params["l1"], cfg.n_heads,
                               cfg.negative_slope, True, group))
    return _gat_layer_local(h, src, dst, params["l2"], cfg.n_heads,
                            cfg.negative_slope, False, group)


def loss_full_ep(params, batch, cfg: GNNConfig, info: GNNEPInfo):
    logits = forward_segment_ep(params, batch["feats"], batch["edge_src"],
                                batch["edge_dst"], cfg, info)
    return node_xent(logits, batch["labels"], batch["mask"])
