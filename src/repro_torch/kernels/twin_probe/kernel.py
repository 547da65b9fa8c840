"""Binding of ``csrc/twin_probe.cu``: the probe-interval intersection with
the |Set_0| count in the same pass.

Replaces ``repro/kernels/twin_probe/kernel.py::twin_probe_pallas``.  On an
H100 it is bound by device memory (each probe row read once, one mask byte
written per column) and, at the serving shapes, by the launch itself; one
thread per column walks the c probes with coalesced row loads, and each
block adds its count with one atomic.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import TWIN_PROBE


def twin_probe_cuda(rows: torch.Tensor, sims0: torch.Tensor, tol: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows (c, N) f32; sims0 (c,) f32; ``tol`` a Python float, passed to
    the kernel as C ``float``.  Returns (mask (N,) bool, count 0-d
    int32)."""
    c, N = rows.shape
    if sims0.shape != (c,):
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, sims0 "
                         f"{tuple(sims0.shape)}")
    if rows.dtype != torch.float32 or sims0.dtype != torch.float32:
        raise TypeError("rows and sims0 must be float32")
    for t in (rows, sims0):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("twin_probe_cuda needs contiguous CUDA tensors")
    mask = torch.empty((N,), dtype=torch.bool, device=rows.device)
    count = torch.zeros((), dtype=torch.int32, device=rows.device)
    if N:
        TWIN_PROBE.launch("twin_probe_f32", rows, sims0, float(tol), mask,
                          count, c, N)
    return mask, count
