"""Public wrappers of the verification kernel and of the arena health
sweep, which share its module (and its source, ``csrc/verify_rows.cu``).

``verify_rows`` and ``live_rows_ok`` launch the kernel's entry points on
CUDA tensors and run the plain versions (``ref.py``) on CPU tensors (on
``meta`` tensors the kernel's empty output, its cost reported to the
active counter).  The JAX wrapper's TPU tiling and interpret arguments
(``bs``, ``bk``, ``interpret``) are dropped: the kernel strides over any
row width, so nothing is padded.  ``live_rows_ok`` is the per-row rule
that ``arena_healthy`` reduces and the replicas' ``bad_rows`` lists; the
JAX package computes it in plain jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.verify_rows.kernel import (ENTRY, live_rows_cuda,
                                                    verify_rows_cuda)
from repro_torch.kernels.verify_rows.ref import (live_rows_ok_ref,
                                                 verify_rows_ref)


def verify_rows(C: torch.Tensor, r0: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """(s, m) candidates vs (m,) target -> (s,) bool verified-twin flags.

    ``C`` and ``r0`` are promoted to one dtype as jnp's ``==`` would
    promote them; on the card the kernel takes float32 and int8 after
    promotion and raises ``NotImplementedError`` for any other dtype."""
    dt = torch.promote_types(C.dtype, r0.dtype)
    C, r0, valid = C.to(dt), r0.to(dt), valid.to(torch.bool)
    if C.is_cuda or C.is_meta:
        if dt not in ENTRY:
            raise NotImplementedError(f"verify_rows: the CUDA kernel takes "
                                      f"float32 or int8, not {dt}")
        return verify_rows_cuda(C.contiguous(), r0.contiguous(),
                                valid.contiguous())
    if C.device.type == "cpu":
        return verify_rows_ref(C, r0, valid)
    raise ValueError(f"verify_rows: unsupported device {C.device}")


# Live rows per slice of the plain version's sweep, and of the replicas'
# repair copies.
HEALTH_CHUNK_ROWS = 4096


def live_rows_ok(sim_vals: torch.Tensor, ratings: torch.Tensor,
                 norms: torch.Tensor, n_active: int) -> torch.Tensor:
    """(n_live,) bool per live row (``n_active`` clamped to the capacity):
    similarity list finite and ascending, ratings finite, norm finite and
    non-negative.  On the card one ``live_rows_f32`` launch; on the CPU
    the plain version, in slices of ``HEALTH_CHUNK_ROWS`` rows."""
    n_live = min(max(int(n_active), 0), ratings.shape[0])
    if ratings.is_cuda or ratings.is_meta:
        return live_rows_cuda(sim_vals, ratings, norms, n_live)
    if ratings.device.type != "cpu":
        raise ValueError(f"live_rows_ok: unsupported device "
                         f"{ratings.device}")
    return live_rows_ok_ref(sim_vals, ratings, norms, n_live,
                            HEALTH_CHUNK_ROWS)


def arena_healthy(sim_vals: torch.Tensor, ratings: torch.Tensor,
                  norms: torch.Tensor, n_active: int) -> torch.Tensor:
    """() bool — every live row passes ``live_rows_ok`` (rows past
    ``n_active`` pass by definition) and ``n_active`` lies within
    capacity."""
    n_ok = 0 <= n_active <= ratings.shape[0]
    return torch.all(live_rows_ok(sim_vals, ratings, norms, n_active)) & n_ok
