"""Public wrapper of the verification kernel, and the arena health checks
that share its module in the JAX package.

``verify_rows`` launches ``csrc/verify_rows.cu`` on CUDA tensors and runs
the plain version (``ref.py``) on CPU tensors.  The JAX wrapper's TPU
tiling and interpret arguments (``bs``, ``bk``, ``interpret``) are dropped:
the kernel strides over any row width, so nothing is padded.
``rows_sorted_finite`` and ``arena_healthy`` are plain PyTorch, as they are
plain jnp in the JAX package; ``live_rows_ok`` is the per-row rule that
``arena_healthy`` reduces and the replicas' ``bad_rows`` lists.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.verify_rows.kernel import ENTRY, verify_rows_cuda
from repro_torch.kernels.verify_rows.ref import verify_rows_ref


def verify_rows(C: torch.Tensor, r0: torch.Tensor, valid: torch.Tensor
                ) -> torch.Tensor:
    """(s, m) candidates vs (m,) target -> (s,) bool verified-twin flags.

    ``C`` and ``r0`` are promoted to one dtype as jnp's ``==`` would
    promote them; on the card the kernel takes float32 and int8 after
    promotion and raises ``NotImplementedError`` for any other dtype."""
    dt = torch.promote_types(C.dtype, r0.dtype)
    C, r0, valid = C.to(dt), r0.to(dt), valid.to(torch.bool)
    if C.is_cuda:
        if dt not in ENTRY:
            raise NotImplementedError(f"verify_rows: the CUDA kernel takes "
                                      f"float32 or int8, not {dt}")
        return verify_rows_cuda(C.contiguous(), r0.contiguous(),
                                valid.contiguous())
    if C.device.type == "cpu":
        return verify_rows_ref(C, r0, valid)
    raise ValueError(f"verify_rows: unsupported device {C.device}")


def rows_sorted_finite(vals: torch.Tensor, n_active: int) -> torch.Tensor:
    """(R,) per-row flags: live rows must be finite and ascending."""
    R = vals.shape[0]
    live = torch.arange(R, device=vals.device) < n_active
    finite = torch.all(torch.isfinite(vals), dim=1)
    ascending = torch.all(torch.diff(vals, dim=1) >= 0, dim=1)
    return (finite & ascending) | ~live


# Live rows per slice of the health sweep: the whole Douban-width arena at
# once would hold about 12 GB of temporaries (``isfinite`` of 7.7 GB of
# ratings allocates their absolute values).
HEALTH_CHUNK_ROWS = 4096


def live_rows_ok(sim_vals: torch.Tensor, ratings: torch.Tensor,
                 norms: torch.Tensor, n_active: int) -> torch.Tensor:
    """(n_live,) bool per live row (``n_active`` clamped to the capacity):
    similarity list finite and ascending, ratings finite, norm finite and
    non-negative.  Swept in slices of ``HEALTH_CHUNK_ROWS`` rows, with no
    sync between slices."""
    n_live = min(max(n_active, 0), ratings.shape[0])
    norms = norms[:n_live]
    ok = torch.isfinite(norms) & (norms >= 0)
    for r0 in range(0, n_live, HEALTH_CHUNK_ROWS):
        r1 = min(n_live, r0 + HEALTH_CHUNK_ROWS)
        ok[r0:r1] &= rows_sorted_finite(sim_vals[r0:r1], r1 - r0)
        ok[r0:r1] &= torch.all(torch.isfinite(ratings[r0:r1]), dim=1)
    return ok


def arena_healthy(sim_vals: torch.Tensor, ratings: torch.Tensor,
                  norms: torch.Tensor, n_active: int) -> torch.Tensor:
    """() bool — every live row passes ``live_rows_ok`` (rows past
    ``n_active`` pass by definition) and ``n_active`` lies within
    capacity."""
    n_ok = 0 <= n_active <= ratings.shape[0]
    return torch.all(live_rows_ok(sim_vals, ratings, norms, n_active)) & n_ok
