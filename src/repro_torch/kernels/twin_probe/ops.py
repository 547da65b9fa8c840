"""Public wrapper of the twin-probe kernel.

``twin_probe`` launches ``csrc/twin_probe.cu`` on CUDA tensors and runs the
plain version (``ref.py``) on CPU tensors (on ``meta`` tensors the
kernel's empty outputs, its cost reported to the active counter); both
compare in the promoted
dtype of the two inputs, as jnp does.  The JAX wrapper's TPU tiling and
interpret arguments (``bn``, ``interpret``) are dropped: the kernel masks
the ragged edge itself, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.twin_probe.kernel import twin_probe_cuda
from repro_torch.kernels.twin_probe.ref import twin_probe_ref


def twin_probe(probe_rows: torch.Tensor, sims0: torch.Tensor, *,
               tol: float = 1e-6) -> tuple[torch.Tensor, torch.Tensor]:
    """(c, N) unsorted probe similarity rows (user-id order) + (c,) probe
    sims -> Set_0 mask (N,) bool and the |Set_0| count (0-d int32, the
    n/125 overflow check's input)."""
    dt = torch.promote_types(probe_rows.dtype, sims0.dtype)
    rows, s0 = probe_rows.to(dt), sims0.to(dt)
    if rows.is_cuda or rows.is_meta:
        if dt != torch.float32:
            raise NotImplementedError(f"twin_probe: the CUDA kernel takes "
                                      f"float32, not {dt}")
        return twin_probe_cuda(rows.contiguous(), s0.contiguous(), tol)
    if rows.device.type == "cpu":
        return twin_probe_ref(rows, s0, tol)
    raise ValueError(f"twin_probe: unsupported device {rows.device}")
