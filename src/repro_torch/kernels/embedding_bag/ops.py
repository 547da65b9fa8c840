"""Public wrapper of the EmbeddingBag kernel.

``embedding_bag`` launches ``csrc/embedding_bag.cu`` on CUDA tensors and
runs the plain version (``ref.py``) on CPU tensors, with the JAX wrapper's
semantics: ``weights`` default to ones, ``mask`` multiplies them, ids are
cast to int32 and clipped to ``[0, V - 1]``, and the output has the
table's dtype.  The JAX wrapper's ``interpret`` argument is dropped.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-combiner EmbeddingBag: (V, dim) table, (n_bags, hot) indices,
    optional per-sample weights and validity mask -> (n_bags, dim)."""
    if weights is None:
        weights = torch.ones(idx.shape, dtype=torch.float32,
                             device=idx.device)
    if mask is not None:
        weights = weights * mask.to(weights.dtype)
    w = weights.float()
    idx = torch.clamp(idx.to(torch.int32), 0, table.shape[0] - 1)
    if table.is_cuda:
        if table.dtype != torch.float32:
            raise NotImplementedError(f"embedding_bag: the CUDA kernel takes "
                                      f"a float32 table, not {table.dtype}")
        return embedding_bag_cuda(table.contiguous(), idx.contiguous(),
                                  w.contiguous())
    if table.device.type == "cpu":
        return embedding_bag_ref(table, idx.long(), w)
    raise ValueError(f"embedding_bag: unsupported device {table.device}")
