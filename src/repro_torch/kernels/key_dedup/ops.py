"""Public wrappers of the key-dedup kernel.

``probe`` and ``verify`` launch ``csrc/key_dedup.cu``'s two kernels on
CUDA tensors and run the plain versions (``ref.py``) on CPU tensors (on
``meta`` tensors the kernel's empty outputs; the probe reports the cost
of both to the active counter).  Both give the same hashes and the same
answer.  A key is the words (a[i], b[i], c[rows[i]] or c[i]), each segment
of a 4-byte dtype; the CF read path keys on (top-k sims, neighbour ids,
the user's rating row) and (sims, ids, item).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.key_dedup.kernel import probe_cuda, verify_cuda
from repro_torch.kernels.key_dedup.ref import key_words, probe_ref, verify_ref


def _on_card(a: torch.Tensor) -> bool:
    if a.is_cuda or a.is_meta:
        return True
    if a.device.type == "cpu":
        return False
    raise ValueError(f"key_dedup: unsupported device {a.device}")


def probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
          rows: torch.Tensor | None = None) -> torch.Tensor:
    """(B, wa), (B, wb) and (N, wc) (rows (B,) in [0, N)) or (B, wc)
    segments -> (B,) int64 key hashes."""
    rows = None if rows is None else rows.long()
    if _on_card(a):
        return probe_cuda(a, b, c, rows)
    return probe_ref(key_words(a, b, c, rows))


def verify(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
           rows: torch.Tensor | None, hashes: torch.Tensor) -> torch.Tensor:
    """The same key and its (B,) hashes -> (B,) int32: for each row the
    first row with a bitwise identical key (itself if none is earlier)."""
    rows = None if rows is None else rows.long()
    if _on_card(a):
        return verify_cuda(a, b, c, rows, hashes)
    return verify_ref(key_words(a, b, c, rows), hashes)


def first_twins(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """``verify`` of ``probe``'s hashes."""
    return verify(a, b, c, rows, probe(a, b, c, rows))
