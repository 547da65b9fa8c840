"""Binding of ``csrc/key_dedup.cu``: twin dedup of a read batch's keys on
the card, a probe hash and then an exact verify, two launches.

Replaces no Pallas kernel: the JAX package dedups read batches on the
host.  It replaces ``serving/dedup.py::dedup_rows``' host route on the CF
read path, whose keys lie on the card, so nothing but the (B,) answer
crosses the bus.  A key is three segments of 4-byte words, each with its
own row stride; the third may be gathered through an int64 row index (the
users' rating rows, read in place in the arena).  At the serving shapes it
is bound by its two launches.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels._lib import KEY_DEDUP, Cost


def cost(B: int, W: int, pairs: int | None = None,
         gathered: bool = True) -> Cost:
    """Both launches of one dedup of ``B`` keys of ``W`` words.  One mix a
    word and one compare a word of each compared pair; the keys read once
    by the probe (and the 8-byte row index of each when the third segment
    is ``gathered``), the 8-byte hashes written and read back once, the
    two keys of each compared pair read by the verify, and the (B,) int32
    answer written once.  ``pairs`` is data; without it, B - 1, the most a
    probe makes when no two distinct keys share a hash (one compare a
    later twin)."""
    if pairs is None:
        pairs = max(B - 1, 0)
    return Cost(flops=float(B * W + pairs * W),
                bytes=4.0 * B * W + (8.0 * B if gathered else 0.0)
                + 16.0 * B + 8.0 * pairs * W + 4.0 * B)


def _key(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
         rows: torch.Tensor | None) -> tuple[int, int, tuple]:
    """Checks a key's segments; returns B, W and the launch arguments."""
    if a.dim() != 2 or b.dim() != 2 or c.dim() != 2:
        raise ValueError("key segments must be 2-D")
    B = a.shape[0]
    if b.shape[0] != B or (rows is None and c.shape[0] != B) or (
            rows is not None and rows.shape != (B,)):
        raise ValueError(f"shape mismatch: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, rows "
                         f"{None if rows is None else tuple(rows.shape)}")
    for t in (a, b, c):
        if t.element_size() != 4:
            raise TypeError(f"key segments must have 4-byte elements, got "
                            f"{t.dtype}")
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError("key segments need unit column stride")
    if rows is not None and (rows.dtype != torch.int64
                             or not rows.is_contiguous()):
        raise TypeError("rows must be contiguous int64")
    for t in (a, b, c) + (() if rows is None else (rows,)):
        if t.device != a.device or not (t.is_cuda or t.is_meta):
            raise ValueError("key_dedup needs CUDA (or meta) tensors on one "
                             "device")
    W = a.shape[1] + b.shape[1] + c.shape[1]
    return B, W, (a, a.shape[1], a.stride(0), b, b.shape[1], b.stride(0),
                  c, rows, c.shape[1], c.stride(0))


def probe_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """The first launch: (B,) int64 hashes (the bits of the kernel's
    unsigned sums) of the keys (a[i], b[i], c[rows[i]] or c[i]).  Reports
    the cost of the whole dedup, the verify's included, to the active
    counter, so a dedup counts as one call (on ``meta`` tensors an empty
    output, and nothing launches)."""
    B, W, args = _key(a, b, c, rows)
    hashes = torch.empty((B,), dtype=torch.int64, device=a.device)
    if _lib.COUNTER is not None:
        _lib.COUNTER.kernel(KEY_DEDUP.name,
                            cost(B, W, gathered=rows is not None))
    if B and not a.is_meta:
        KEY_DEDUP.launch("key_dedup_probe", *args, hashes, B)
    return hashes


def verify_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                rows: torch.Tensor | None, hashes: torch.Tensor
                ) -> torch.Tensor:
    """The second launch: (B,) int32, for each key the first identical one
    among those with its hash in ``hashes`` (B,) int64, itself when there
    is none (on ``meta`` tensors an empty output, and nothing launches)."""
    B, _, args = _key(a, b, c, rows)
    if hashes.shape != (B,) or hashes.dtype != torch.int64 \
            or hashes.device != a.device or not hashes.is_contiguous():
        raise ValueError("hashes must be contiguous (B,) int64 beside the "
                         "key")
    first = torch.empty((B,), dtype=torch.int32, device=a.device)
    if B and not a.is_meta:
        KEY_DEDUP.launch("key_dedup_verify", *args, hashes, first, B)
    return first
