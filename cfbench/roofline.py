"""Frozen yardsticks: the H100's peaks and the least work of each step.

These are the benchmark's own copies, so a change to the program's cost
formulas (``repro_torch.kernels.<name>.kernel.cost``,
``repro_torch.launch.roofline``) cannot change what a share is measured
against.  A test holds ``build_flops`` to the similarity kernel's
formula at the build's shapes, so a change to either shows.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates without sparsity.
"""
from __future__ import annotations

BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def build_flops(n: int, m: int) -> float:
    """The full similarity build of n users over m items: 2·n²·m
    operations (one multiply and one add per product term)."""
    return 2.0 * n * n * m


def build_bound_s(n: int, m: int) -> float:
    """The least time of a bf16 build: its operations at the bf16 peak
    (the product's bytes lie far below: it is compute-bound)."""
    return build_flops(n, m) / BF16_FLOPS_PER_S


def rotation_bytes(n_old: int, n_new: int) -> float:
    """The least bytes an arena rotation moves: the old (n_old, n_old)
    lists read once and the new (n_new, n_new) lists written once, each
    entry a float32 value and an int32 id."""
    return 8.0 * n_old * n_old + 8.0 * n_new * n_new


def rotation_bound_s(n_old: int, n_new: int) -> float:
    return rotation_bytes(n_old, n_new) / HBM_BYTES_PER_S
