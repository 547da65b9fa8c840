"""Plain PyTorch version of the EmbeddingBag kernel.

    out[b, :] = Σ_h table[idx[b, h], :] · w[b, h]

added over h in serial order from zero, one rounded multiply and one
rounded add per step, as the Pallas kernel's revisited output block adds
them; the CUDA kernel uses the same order, so the two agree bit for bit.
The sum is kept in the table's dtype.
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """table (V, dim); idx (n_bags, hot) in [0, V); w (n_bags, hot) f32.
    Returns (n_bags, dim) in the table's dtype."""
    n_bags, hot = idx.shape
    out = torch.zeros((n_bags, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for h in range(hot):
        out = (out + table[idx[:, h]] * w[:, h, None]).to(table.dtype)
    return out
