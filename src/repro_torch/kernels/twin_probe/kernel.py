"""Binding of ``csrc/twin_probe.cu``: the probe-interval intersection with
the |Set_0| count in the same pass.

Replaces ``repro/kernels/twin_probe/kernel.py::twin_probe_pallas``.  On an
H100 the serving shapes (8 probe rows of ~33k columns) are bound by the
launch itself, so a call is one launch and one allocation (the mask and
the count share one buffer).  Each block adds its arrival and its count to
a per-stream ticket in one atomic, and the last block to arrive writes the
total and leaves the ticket at 0.  Details in the source."""
from __future__ import annotations

import torch

from repro_torch.kernels._lib import TWIN_PROBE

# One ticket per (device, stream): a 64-bit word that each launch takes
# back to 0, so calls on one stream reuse it in turn and calls on two
# streams never share one.
_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _ticket(stream: torch.cuda.Stream) -> torch.Tensor:
    key = (stream.device_index, stream.cuda_stream)
    t = _tickets.get(key)
    if t is None:
        with torch.cuda.stream(stream):
            t = torch.zeros(1, dtype=torch.int64, device=stream.device)
        _tickets[key] = t
    return t


def twin_probe_cuda(rows: torch.Tensor, sims0: torch.Tensor, tol: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """rows (c, N) f32; sims0 (c,) f32; ``tol`` a Python float, passed to
    the kernel as C ``float``.  Returns (mask (N,) bool, count 0-d int32),
    views of one buffer."""
    c, N = rows.shape
    if sims0.shape != (c,):
        raise ValueError(f"shape mismatch: rows {tuple(rows.shape)}, sims0 "
                         f"{tuple(sims0.shape)}")
    if rows.dtype != torch.float32 or sims0.dtype != torch.float32:
        raise TypeError("rows and sims0 must be float32")
    for t in (rows, sims0):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("twin_probe_cuda needs contiguous CUDA tensors")
    if N == 0:
        return (torch.empty((0,), dtype=torch.bool, device=rows.device),
                torch.zeros((), dtype=torch.int32, device=rows.device))
    # [mask, padded to 4 bytes][count]
    mask_bytes = -(-N // 4) * 4
    buf = torch.empty(mask_bytes + 4, dtype=torch.uint8, device=rows.device)
    mask = buf[:N].view(torch.bool)
    count = buf[mask_bytes:].view(torch.int32)[0]
    vec = int(N % 4 == 0 and rows.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(rows.device)
    TWIN_PROBE.launch("twin_probe_f32", rows, sims0, float(tol), mask,
                      count, _ticket(stream), c, N, vec, stream=stream)
    return mask, count
