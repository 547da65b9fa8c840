"""Roofline terms of a step (PyTorch port of ``repro.launch.roofline``).

The reference reads XLA's compiled program: ``cost_analysis()`` for the
per-device FLOPs and bytes, and the HLO text for the collectives (each
all-gather / all-reduce / reduce-scatter / all-to-all / collective-permute,
its result bytes per device).  The port's program (``launch.steps.
jit_cell(...).lower(...).compile()``) answers the same three questions from
a trace on ``meta`` tensors (``launch.trace``), and ``analyze`` reads it
as the reference reads XLA's:

  t_compute    = (flops - flops_f32) / PEAK_FLOPS
                 + flops_f32 / PEAK_FLOPS_F32
  t_memory     = bytes / HBM_BW
  t_collective = coll_bytes / ICI_BW

The constants are one NVIDIA H100 SXM's.  With ``flops_f32 = 0`` every
term is the reference's formula; the fp32 term exists because this card,
without TF32, has two peak rates where the reference's cost model has one.
The dominant term is the projected bottleneck; model FLOPs over counted
FLOPs is the useful fraction.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field

# bf16, dense, on the tensor cores (NVIDIA H100 SXM data sheet).
PEAK_FLOPS = 989e12
# fp32 on the CUDA cores (data sheet): the fidelity rules forbid TF32, so
# every float32 product runs here.
PEAK_FLOPS_F32 = 67e12
# HBM3, 80 GB (data sheet).
HBM_BW = 3.35e12
# NVLink 4: 900 GB/s bidirectional to the other cards of the NVLink domain,
# 450 GB/s each way (Hopper architecture white paper).  Every collective is
# priced at this one rate, as the reference prices all at one ICI rate.
ICI_BW = 450e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\][^ ]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(-start)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(shape_text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_census(hlo_text: str) -> dict[str, dict]:
    """Per-op-kind {count, bytes} from HLO text (result-shape bytes, per
    device; ``-done`` ops skipped so start/done pairs count once)."""
    out: dict[str, dict] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_text, kind = m.group(1), m.group(2)
        rec = out.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += _shape_bytes(shape_text)
    return out


@dataclass
class RooflineTerms:
    flops: float
    bytes_hbm: float
    bytes_coll: float
    model_flops: float = 0.0
    collectives: dict = field(default_factory=dict)
    flops_f32: float = 0.0           # the part of ``flops`` in fp32

    @property
    def t_compute(self) -> float:
        return ((self.flops - self.flops_f32) / PEAK_FLOPS
                + self.flops_f32 / PEAK_FLOPS_F32)

    @property
    def t_memory(self) -> float:
        return self.bytes_hbm / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.bytes_coll / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_fraction(self) -> float:
        if self.flops <= 0:
            return 0.0
        return self.model_flops / self.flops

    def as_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "bytes_per_device": self.bytes_hbm,
            "coll_bytes_per_device": self.bytes_coll,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "model_flops_per_device": self.model_flops,
            "useful_fraction": self.useful_fraction,
            "collectives": self.collectives,
        }


def analyze(compiled, model_flops_per_device: float = 0.0) -> RooflineTerms:
    """Roofline terms of ``compiled``: an object with the reference's
    ``cost_analysis()`` (``"flops"``, ``"bytes accessed"`` and, from the
    port's programs, ``"flops f32"``, the part of ``"flops"`` in fp32) and
    ``as_text()`` (HLO-style text of its collectives)."""
    cost = compiled.cost_analysis() or {}
    census = collective_census(compiled.as_text())
    coll_bytes = sum(v["bytes"] for v in census.values())
    return RooflineTerms(
        flops=float(cost.get("flops", 0.0)),
        bytes_hbm=float(cost.get("bytes accessed", 0.0)),
        bytes_coll=float(coll_bytes),
        model_flops=model_flops_per_device,
        collectives=census,
        flops_f32=float(cost.get("flops f32", 0.0)),
    )
