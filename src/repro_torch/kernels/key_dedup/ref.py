"""Plain PyTorch version of the key-dedup kernel.

A key is the row of 4-byte words (a[i], b[i], c[rows[i]] or c[i]).

    hash[i]  = Σ_p mix(w[i, p], p) mod 2^64
    first[i] = min { j <= i : hash[j] == hash[i], w[j] == w[i] bitwise }

``mix`` is splitmix64's finaliser of the 64-bit (p << 32 | w), in int64
with wrapping products and logical shifts, so the hashes equal the
kernel's bit for bit.  The hash only narrows which keys are compared: the
answer depends on bitwise equality alone.
"""
from __future__ import annotations

import torch

_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)     # the constants as int64 bits
_M2 = 0x94D049BB133111EB - (1 << 64)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 else t.view(torch.int32)


def key_words(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
              rows: torch.Tensor | None = None) -> torch.Tensor:
    """(B, W) int32: each key's words, the segments' bits side by side."""
    third = c if rows is None else c[rows]
    return torch.cat([_bits(a), _bits(b), _bits(third)], dim=1)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def probe_ref(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 -> (B,) int64 hashes."""
    pos = torch.arange(words.shape[1], dtype=torch.int64,
                       device=words.device) << 32
    x = pos | (words.to(torch.int64) & 0xFFFFFFFF)
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return torch.sum(x ^ _shr(x, 31), dim=1)


def verify_ref(words: torch.Tensor, hashes: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 and (B,) int64 -> (B,) int32 first identical rows."""
    B = words.shape[0]
    first = torch.arange(B, dtype=torch.int32, device=words.device)
    for i in range(1, B):
        cand = torch.nonzero(hashes[:i] == hashes[i]).flatten()
        if cand.numel():
            hit = cand[torch.all(words[cand] == words[i], dim=1)]
            if hit.numel():
                first[i] = hit[0]
    return first
