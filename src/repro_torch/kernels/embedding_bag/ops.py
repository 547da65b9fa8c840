"""Public wrapper of the EmbeddingBag kernel.

``embedding_bag`` launches ``csrc/embedding_bag.cu`` on CUDA tensors and
runs the plain version (``ref.py``) on CPU tensors (on ``meta`` tensors
the kernel's empty output, its cost reported to the active counter), with
the JAX wrapper's semantics: ``weights`` default to ones, ``mask``
multiplies them, ids are cast to int32 and clipped to ``[0, V - 1]``, and
the output has the table's dtype.  On the card the kernel clips the ids and multiplies the
mask in itself, so float32 weights (or none) with a bool mask (or none)
and int32 ids make one launch; other dtypes go through the same steps on
the host first, so their rounding is unchanged.  The JAX wrapper's
``interpret`` argument is dropped.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref


def _weights(idx: torch.Tensor, weights: torch.Tensor | None,
             mask: torch.Tensor | None) -> torch.Tensor:
    """The JAX wrapper's weight steps: ones by default, times the mask in
    the weights' dtype, then float32."""
    if weights is None:
        weights = torch.ones(idx.shape, dtype=torch.float32,
                             device=idx.device)
    if mask is not None:
        weights = weights * mask.to(weights.dtype)
    return weights.float()


def embedding_bag(table: torch.Tensor, idx: torch.Tensor,
                  weights: torch.Tensor | None = None,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Sum-combiner EmbeddingBag: (V, dim) table, (n_bags, hot) indices,
    optional per-sample weights and validity mask -> (n_bags, dim)."""
    idx = idx.to(torch.int32)            # cast first: int64 ids wrap as jnp
    if table.is_cuda or table.is_meta:
        if table.dtype != torch.float32:
            raise NotImplementedError(f"embedding_bag: the CUDA kernel takes "
                                      f"a float32 table, not {table.dtype}")
        w_in_kernel = weights is None or (weights.dtype == torch.float32
                                          and weights.shape == idx.shape)
        mask_in_kernel = mask is None or (mask.dtype == torch.bool
                                          and mask.shape == idx.shape)
        if not (w_in_kernel and mask_in_kernel):
            weights, mask = _weights(idx, weights, mask), None
        return embedding_bag_cuda(
            table.contiguous(), idx.contiguous(),
            None if weights is None else weights.contiguous(),
            None if mask is None else mask.contiguous())
    if table.device.type == "cpu":
        idx = torch.clamp(idx, 0, table.shape[0] - 1)
        return embedding_bag_ref(table, idx.long(),
                                 _weights(idx, weights, mask))
    raise ValueError(f"embedding_bag: unsupported device {table.device}")
