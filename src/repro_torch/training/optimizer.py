"""Optimizers (PyTorch port of ``repro.training.optimizer``): parameters
and optimizer state as nested trees of tensors.

AdamW with fp32 master weights + moments (params may live in bf16), global
gradient-norm clipping, and warmup-cosine schedules.  The state layout is
the reference's NamedTuple of trees, so checkpoints name the same leaves.
``update`` runs under ``torch.no_grad()``, leaf by leaf, in the reference's
order of operations, and updates the state's tensors in place, as the
reference's donated buffers are (an xDeepFM or AutoInt table's moments
and master are gigabytes each).  The params it returns are copies: they
never alias the master weights, so the params given to the next step are
not written by it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # 0-d int32
    mu: dict
    nu: dict
    master: dict          # fp32 copy of the params


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _from_master(master, params):
    """New params: each master leaf cast to its param's dtype, a copy for
    fp32 leaves too (the next update writes the master in place)."""
    return tree_map(lambda w, p: w.to(p.dtype, copy=True), master, params)


def _step0(params) -> torch.Tensor:
    first = leaves(params)
    device = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=device)


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float | None = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(
            step=_step0(params),
            mu=tree_map(_zeros32, params),
            nu=tree_map(_zeros32, params),
            # a copy: the master weights never alias the params
            master=tree_map(lambda p: p.detach().to(torch.float32,
                                                    copy=True), params),
        )

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> tuple[dict, AdamWState]:
        """One step.  ``state``'s moments and master weights are updated
        in place, leaf by leaf (the reference's train cells donate the
        optimizer state to the step, so XLA reuses its buffers the same
        way); the returned state holds those tensors and a new step count.
        The returned params are new tensors, the master weights cast to
        each param's dtype (for fp32 params a copy: as in the reference,
        they never alias the master).  The grads and params given are not
        written."""
        g32 = [g.float() for g in leaves(grads)]
        scale = None
        if self.clip_norm is not None:
            gn = global_norm(g32)
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(gn, 1e-12), 1.0)
        step = state.step + 1
        t = step.float()
        bc1 = 1.0 - self.b1 ** t
        bc2 = 1.0 - self.b2 ** t
        lr = self._lr(step)
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        for g, m, v, w in zip(g32, leaves(state.mu), leaves(state.nu),
                              leaves(state.master)):
            if scale is not None:
                g = g * scale
            m.mul_(b1).add_(g * (1 - b1))        # b1·m + (1 - b1)·g
            v.mul_(b2).add_(torch.square(g).mul_(1 - b2))
            upd = m / bc1                        # m̂
            denom = (v / bc2).sqrt_().add_(eps)  # sqrt(v̂) + eps
            upd.div_(denom).add_(torch.mul(w, wd, out=denom))
            w.sub_(upd.mul_(lr))                 # w - lr·(m̂/(…) + wd·w)
            del g, upd, denom
        return _from_master(state.master, params), state._replace(step=step)


@dataclass(frozen=True)
class SGD:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-2
    momentum: float = 0.9

    def init(self, params):
        return AdamWState(
            step=_step0(params),
            mu=tree_map(_zeros32, params),
            nu={}, master=tree_map(lambda p: p.detach().to(
                torch.float32, copy=True), params))

    @torch.no_grad()
    def update(self, grads, state, params):
        """One step, the momentum and master weights updated in place as
        in ``AdamW.update``."""
        lr = self.lr(state.step + 1) if callable(self.lr) else self.lr
        for m, g, w in zip(leaves(state.mu), leaves(grads),
                           leaves(state.master)):
            m.mul_(self.momentum).add_(g.float())
            w.sub_(m * lr)
        return (_from_master(state.master, params),
                state._replace(step=state.step + 1))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in ``jax.tree.leaves`` order, of
    each leaf's fp32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    def sched(step) -> torch.Tensor:
        t = torch.as_tensor(step).float()
        warm = t / max(warmup_steps, 1)
        frac = torch.clamp((t - warmup_steps) / max(total_steps -
                                                     warmup_steps, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return peak * torch.minimum(warm, cos)
    return sched
