"""Expert-parallel MoE on ``torch.distributed`` (PyTorch port of
``repro.models.moe_ep``): the token <-> expert exchange as the textbook pair
of all-to-alls over the model axis, with FSDP weight shards all-gathered
over the data axes (and reduce-scattered in the backward):

  tokens (sharded dp x mp)  --a2a-->  expert rows (E/mp experts per rank)
        expert GEMMs (full f, weights gathered over dp)
  expert rows  --a2a-->  tokens, combine with gates

``moe_ffn_ep`` is one rank's program of the reference's ``shard_map``: it
takes this rank's shards of the activations and of the expert weights (the
blocks ``distributed.sharding.named(...)`` gives it) and the whole router,
and runs where they are.  Its process groups come from ``info.mesh`` (a
``DeviceMesh``, ``launch.mesh``): the model axis for the all-to-alls, the
data axes (first axis major, as JAX orders ``("pod", "data")``) for the
weight gathers, every axis for the aux loss's sums.

Semantics match ``moe.py`` when nothing overflows capacity (the same
per-token expert products); capacity is counted on the local shard,
``C = max(8, ceil8(T·k·cf/E))`` for the rank's T tokens, the standard EP
formulation.  The router logits are float32 sums of exact products
(``matmul_f32``) and ``sorting.top_k`` puts the lower expert first on ties,
as ``lax.top_k`` does.  The dispatch is an ``index_add`` into an (E·C, d)
buffer: every valid choice owns its slot, and a dropped choice adds an
exact zero to its expert's last slot, so the sum has the same bits in any
order.

Gradients follow the reference's ``shard_map(check_vma=False)``
transposition, so each rank holds its shard of JAX's ``jax.grad``: the
cotangent of an output is divided by the size of the mesh axes its spec
leaves out (the aux loss, replicated, by the mesh's size); the cotangent
of an input is summed over the axes its spec leaves out (the router over
every axis); the aux loss's sums transpose to sums, the weight gathers to
reduce-scatters and each all-to-all to the reverse all-to-all.  Summing
each rank's replicated aux loss into its own loss without the division
would count it once per rank.

The collectives are small autograd functions here, not
``torch.distributed.nn.functional``'s: on gloo (which has no
reduce-scatter) that module's ``all_gather`` backward scatters with group
ranks where ``dist.scatter`` wants global ones, and fails on any subgroup
other than ranks 0..n-1 (torch 2.13), such as a data axis.  The gather's
backward here is a reduce-scatter (NCCL, and the ``"fake"`` backend of a
dry run) and, on gloo, an all-reduce of the whole cotangent of which each
rank keeps its block.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.launch.mesh import axis_group
from repro_torch.models.layers import _gelu_tanh, matmul_f32
from repro_torch.sorting import top_k


class MoEEPInfo(NamedTuple):
    """Static routing info the sharding layer hands the model."""

    dp: tuple[str, ...]          # data axes (token sharding / weight FSDP)
    mp: str                      # model axis (expert sharding / all-to-all)
    mp_size: int
    win_spec: object             # P of the sliced (E, d, gf·f) w_in
    wout_spec: object            # P of the sliced (E, f, d) w_out
    acts_spec: object            # P of the (B, S, d) activations
    mesh: object = None          # DeviceMesh (bound at cell build)


def _gather_axes(spec) -> tuple:
    """dp axes on the last dim of a weight spec (() = not FSDP-sharded)."""
    last = tuple(spec)[-1] if len(tuple(spec)) else None
    if last is None:
        return ()
    return last if isinstance(last, tuple) else (last,)


def _unmentioned(mesh, spec) -> tuple[tuple[str, ...], int]:
    """The mesh axes ``spec`` does not name, and the product of their
    sizes."""
    named = {a for p in tuple(spec) if p is not None
             for a in (p if isinstance(p, tuple) else (p,))}
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in names if a not in named)
    n = math.prod(mesh.mesh.shape[names.index(a)] for a in axes)
    return axes, n


class _SumCotangent(torch.autograd.Function):
    """Identity forward; the backward sums the cotangent over ``group``
    (an input replicated over the axes its spec leaves out)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _DivideCotangent(torch.autograd.Function):
    """Identity forward; the backward divides the cotangent by ``n`` (an
    output replicated over ``n`` ranks)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _enter(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    axes, n = _unmentioned(mesh, spec)
    if n == 1 or not torch.is_grad_enabled():
        return x
    return _SumCotangent.apply(x, axis_group(mesh, axes))


def _leave(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    _, n = _unmentioned(mesh, spec)
    if n == 1 or not torch.is_grad_enabled():
        return x
    return _DivideCotangent.apply(x, n)


class _AllReduceSum(torch.autograd.Function):
    """``psum``: forward and backward both sum over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all on dim 0: block p goes to peer p; the result holds
    the peers' blocks in peer order.  Its own transpose."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGatherLast(torch.autograd.Function):
    """Tiled all-gather of the last dim over ``group`` (group rank
    order); the backward sums the ranks' cotangents of this rank's block."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        parts = [torch.empty_like(w) for _ in range(dist.get_world_size(
            group))]
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        chunks = [c.contiguous() for c in g.chunk(n, dim=-1)]
        if dist.get_backend(ctx.group) != dist.Backend.GLOO:
            out = torch.empty_like(chunks[0])
            dist.reduce_scatter(out, chunks, group=ctx.group)
            return out, None
        total = torch.cat(chunks, dim=-1)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=ctx.group)
        return total.chunk(n, dim=-1)[dist.get_rank(ctx.group)].contiguous(), \
            None


def _gather_last(w: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """The all-gather of the last dim over ``axes`` (first axis major)."""
    if not axes:
        return w
    return _AllGatherLast.apply(w, axis_group(mesh, axes))


def moe_ffn_ep(x: torch.Tensor, router_w: torch.Tensor, w_in: torch.Tensor,
               w_out: torch.Tensor, cfg: MoEConfig, act: str,
               info: MoEEPInfo) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (out, aux_loss): ``x`` its (B_loc, S_loc, d) block of
    the activations under ``info.acts_spec``, ``w_in``/``w_out`` its
    blocks of the (E, d, gf·f) and (E, f, d) expert weights under
    ``info.win_spec``/``info.wout_spec``, ``router_w`` the whole (d, E)
    router.  ``out`` is this rank's block of the output; the float32 aux
    loss is the global one, on every rank."""
    mesh = info.mesh
    if mesh is None:
        raise RuntimeError("moe_ffn_ep needs info.mesh, a DeviceMesh "
                           "(launch.mesh; launch.steps.build_cell binds it)")
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    mp_n = info.mp_size
    if E % mp_n:
        raise ValueError(f"{E} experts do not split over {mp_n} model ranks")
    E_loc = E // mp_n
    mp_group = axis_group(mesh, info.mp)

    x = _enter(x, mesh, info.acts_spec)
    router_w = _enter(router_w, mesh, ())
    w_in = _enter(w_in, mesh, info.win_spec)
    w_out = _enter(w_out, mesh, info.wout_spec)

    T = B * S
    xt = x.reshape(T, d)
    logits = matmul_f32(xt, router_w.to(xt.dtype))
    probs = torch.softmax(logits, dim=-1)                 # (T, E) fp32
    gates, eidx = top_k(probs, k)                         # (T, k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)

    C = max(8, -(-int(T * k * cfg.capacity_factor / E) // 8) * 8)
    flat_e = eidx.reshape(-1)                             # (T·k,)
    onehot = F.one_hot(flat_e, E)
    pos = torch.sum((torch.cumsum(onehot, dim=0) - 1) * onehot, dim=-1)
    counts = onehot.sum(dim=0)
    del onehot
    valid = pos < C
    slot = flat_e * C + torch.clamp_max(pos, C - 1)       # [0, E·C)

    xk = torch.repeat_interleave(xt, k, dim=0) * valid[:, None].to(xt.dtype)
    send = xt.new_zeros((E * C, d)).index_add(0, slot, xk)
    del xk

    # ---- dispatch all-to-all over the model axis ----
    recv = _AllToAll.apply(send, mp_group)
    del send
    # (mp·E_loc·C, d): peer-major blocks of my local experts' rows.
    recv = recv.reshape(mp_n, E_loc, C, d).transpose(0, 1).reshape(
        E_loc, mp_n * C, d)

    # ---- expert GEMMs (FSDP weight shards gathered over dp) ----
    w_in_full = _gather_last(w_in, mesh, _gather_axes(info.win_spec))
    w_out_full = _gather_last(w_out, mesh, _gather_axes(info.wout_spec))
    h = torch.bmm(recv, w_in_full.to(recv.dtype))
    del recv
    if act in ("swiglu", "geglu"):
        g, u = torch.chunk(h, 2, dim=-1)
        inner = {"swiglu": F.silu, "geglu": _gelu_tanh}[act](g) * u
    else:
        inner = _gelu_tanh(h)
    del h
    out = torch.bmm(inner, w_out_full.to(inner.dtype))
    del inner

    # ---- combine all-to-all (reverse of dispatch) ----
    back = out.reshape(E_loc, mp_n, C, d).transpose(0, 1).reshape(E * C, d)
    ret = _AllToAll.apply(back, mp_group)
    del out, back
    w = (gates.reshape(-1) * valid.float()).to(ret.dtype)
    y = torch.sum((ret[slot] * w[:, None]).reshape(T, k, d), dim=1)
    y = y.reshape(B, S, d)

    # ---- global load-balance aux (Switch): the three sums in one ----
    stats = torch.cat([counts.float(), probs.sum(dim=0),
                       torch.full((1,), float(T), device=probs.device)])
    stats = _AllReduceSum.apply(stats, axis_group(mesh))
    frac, prob, t_tot = stats[:E], stats[E:2 * E], stats[2 * E]
    aux = E * torch.sum((frac / (k * t_tot)) * (prob / t_tot))
    return _leave(y, mesh, info.acts_spec), _leave(aux, mesh, ())
