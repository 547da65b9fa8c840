"""Top-k gradient compression with error feedback (PyTorch port of
``repro.training.compression``; Deep Gradient Compression-style) for
bandwidth-constrained links between hosts.

``compress`` keeps the largest-|g| fraction per leaf and accumulates the
residual into an error-feedback buffer that is replayed next step, keeping
the optimizer unbiased in expectation.  The sparsified gradient is returned
dense (zeros elsewhere); on a real fabric the (indices, values) pairs are
what cross hosts, and ``wire_bytes`` reports that cost.  The threshold is
the k-th largest |g|, read from ``torch.topk``'s values only, so the order
``topk`` gives equal values in cannot change a mask.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten

DENSE_MAX = 64                          # leaves this small always go dense


class EFState(NamedTuple):
    residual: dict


def init_ef(params) -> EFState:
    return EFState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _topk_mask(g: torch.Tensor, keep_frac: float) -> torch.Tensor:
    if g.numel() <= DENSE_MAX:
        return torch.ones_like(g, dtype=torch.bool)
    k = max(1, int(g.numel() * keep_frac))
    thresh = torch.topk(torch.abs(g.reshape(-1)), k).values[-1]
    return torch.abs(g) >= thresh


@torch.no_grad()
def compress(grads, ef: EFState, keep_frac: float = 0.01
             ) -> tuple[dict, EFState]:
    """Returns (sparsified grads, updated error-feedback state)."""
    def per_leaf(g, r):
        acc = g.float() + r
        mask = _topk_mask(acc, keep_frac)
        sent = torch.where(mask, acc, 0.0)
        return sent.to(g.dtype), acc - sent

    pairs = [per_leaf(g, r) for g, r in zip(leaves(grads),
                                            leaves(ef.residual))]
    sent = unflatten(grads, [p[0] for p in pairs])
    resid = unflatten(ef.residual, [p[1] for p in pairs])
    return sent, EFState(residual=resid)


def wire_bytes(params, keep_frac: float) -> int:
    """Bytes a real sparse all-reduce would move per step (idx32 + fp16)."""
    total = 0
    for p in leaves(params):
        if p.numel() <= DENSE_MAX:
            total += p.numel() * 2
        else:
            total += int(p.numel() * keep_frac) * (4 + 2)
    return total
