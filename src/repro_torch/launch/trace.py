"""Counting a step without running it: the port's stand-in for XLA's cost,
memory and collective analyses of a compiled program, which
``launch.steps.jit_cell`` and ``launch.dryrun`` read.

``Counter`` is a ``TorchDispatchMode``.  While it is active, every aten
operation a step dispatches (forward and backward) is counted, on ``meta``
tensors (shapes and dtypes, no data: nothing is allocated or computed) and
on the card alike:

  * FLOPs: ``torch.utils.flop_counter``'s formulas for the products (mm,
    bmm, addmm, baddbmm, convolutions, attention) and 2·n·m for a
    matrix-vector product, split by the product's
    operand dtype: float32 products run on the CUDA cores at the fp32 rate
    (no TF32, by the port's fidelity rules), the others on the tensor
    cores.  Each hand-written kernel adds its own formula
    (``kernels.<name>.kernel.cost``), which its binding reports while a
    counter is active (``kernels._lib.COUNTER``).  Elementwise operations
    count no FLOPs, as in the flop counter (XLA's count includes them).
  * HBM bytes: every operation's input bytes plus its output bytes; views,
    allocations, copies between the host and the device (PCIe traffic)
    and collectives move none, and a fill or copy into a tensor does not
    read it.  An indexed operation moves the elements it
    touches, not its whole source or destination: a gather (``index``,
    ``index_select``, ``gather``, ``embedding``, ``take``) reads its
    indices and the elements it gathers (at most its source) and writes
    its output; a scatter (``index_add``, ``index_copy``, ``index_put``,
    ``index_reduce``, ``scatter*``) reads its indices and its source and
    reads and writes the elements they name (at most its destination),
    an out-of-place one as if it updated its destination in place, as XLA
    does.  This is an eager, unfused upper bound: a fused program keeps
    intermediates out of device memory that this count charges for.
  * Live bytes: each storage an operation creates counts from its creation
    until it is freed (a weak reference on the storage; autograd's saved
    tensors keep theirs alive), and the peak of their sum is kept.
  * Kernel calls: each hand-written kernel's calls and their summed cost.

``Collectives`` records every ``torch.distributed`` collective called while
it is active (kind, result shape, dtype, group size), and ``record`` adds
collectives that a rule derives; ``hlo_text`` writes them one HLO-style line
each, which ``launch.roofline.collective_census`` reads as it reads XLA's.

``fake_world(n)`` opens a process group of ``n`` ranks on PyTorch's
``"fake"`` backend, whose collectives do nothing, for a trace on ``meta``
tensors; its store, ``torch.testing._internal.distributed.fake_pg.
FakeStore``, is a private PyTorch API.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _lib

_aten = torch.ops.aten
# Allocations: they write no data (views are told by their schema).
_NO_TRAFFIC = {_aten.empty.memory_format, _aten.empty_strided.default,
               _aten.empty_like.default, _aten.new_empty.default,
               _aten.new_empty_strided.default}


def _mv_flops(a, b, *args, out_val=None, **kwargs) -> int:
    """2·n·m for an (n, m) matrix times an m-vector (``aten.mv``, which the
    flop counter leaves out; ``cosine_vs_all``'s product)."""
    return 2 * a.numel()


_FLOPS = {**flop_registry, _aten.mv: _mv_flops}


# They write their first input without reading it.
_OVERWRITES = {_aten.fill_, _aten.zero_, _aten.copy_}
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding,
            _aten.take}
_SCATTERS = {_aten.index_add, _aten.index_add_, _aten.index_copy,
             _aten.index_copy_, _aten.index_put, _aten.index_put_,
             _aten._index_put_impl_, _aten.index_reduce, _aten.index_reduce_,
             _aten.scatter, _aten.scatter_, _aten.scatter_add,
             _aten.scatter_add_, _aten.scatter_reduce, _aten.scatter_reduce_}


def _traffic(func, ins, outs) -> int:
    """HBM bytes of one operation (see the module): the first input of a
    gather is its source, of a scatter its destination."""
    packet = func.overloadpacket
    if packet in _OVERWRITES:
        return sum(map(nbytes, ins[1:])) + sum(map(nbytes, outs))
    if packet in _GATHERS:
        out = sum(map(nbytes, outs))
        return sum(map(nbytes, ins[1:])) + min(nbytes(ins[0]), out) + out
    if packet in _SCATTERS:
        dest, rest = ins[0], ins[1:]
        touched = max(t.numel() for t in rest) * dest.element_size()
        return sum(map(nbytes, rest)) + 2 * min(nbytes(dest), touched)
    return sum(map(nbytes, ins)) + sum(map(nbytes, outs))


def _host_copy(func, ins, outs) -> bool:
    """A copy between the host and the device: PCIe traffic, not HBM's.
    (Callers cache such copies, as ``models.embedding`` its offsets, so a
    first call would otherwise count bytes that a later call does not.)"""
    return (func in (_aten._to_copy.default, _aten.copy_.default)
            and {t.device.type == "cpu" for t in ins + outs} == {True,
                                                                 False})


def tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Counter(TorchDispatchMode):
    """FLOPs (bf16/other and fp32), HBM bytes, live-byte peak and kernel
    calls of everything dispatched while active (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0                 # priced at the tensor-core rate
        self.flops_f32 = 0.0             # priced at the fp32 rate
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.kernels: dict[str, dict[str, float]] = {}
        self._storages: dict[int, int] = {}

    def __enter__(self):
        self._outer, _lib.COUNTER = _lib.COUNTER, self
        return super().__enter__()

    def __exit__(self, *exc):
        _lib.COUNTER = self._outer
        return super().__exit__(*exc)

    def kernel(self, name: str, cost: _lib.Cost) -> None:
        """One call of a hand-written kernel (its binding reports it)."""
        rec = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                             "bytes": 0.0})
        rec["calls"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.bytes
        self._add_flops(cost.flops, cost.fp32)
        self.bytes += cost.bytes

    def _add_flops(self, flops: float, fp32: bool) -> None:
        if fp32:
            self.flops_f32 += flops
        else:
            self.flops += flops

    def _freed(self, key: int, size: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live -= size

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = tensors((args, kwargs))
        outs = tensors(out)
        formula = _FLOPS.get(func.overloadpacket)
        if formula is not None:
            # The ``.dtype`` overloads (a float32 result of bf16 operands)
            # take the result's dtype positionally; the formulas do not.
            shapes = [a for a in args if not isinstance(a, torch.dtype)]
            self._add_flops(float(formula(*shapes, **kwargs, out_val=out)),
                            bool(ins) and ins[0].dtype == torch.float32)
        if not (func in _NO_TRAFFIC or func.is_view
                or func.namespace == "c10d" or _host_copy(func, ins, outs)):
            self.bytes += _traffic(func, ins, outs)
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._storages:
                continue
            size = st.nbytes()
            self._storages[key] = size
            self.live += size
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._freed, key, size)
        return out


_DTYPE_NAMES = {torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
                torch.int16: "s16", torch.float16: "f16",
                torch.bfloat16: "bf16", torch.int32: "s32",
                torch.float32: "f32", torch.int64: "s64",
                torch.float64: "f64"}


class Collectives:
    """Records the collectives of ``torch.distributed`` called while it is
    active (the call goes through: on the ``"fake"`` backend it does
    nothing) and those ``record`` adds.  Each event is (kind, result shape,
    dtype, group size, count); the kinds are HLO's names."""

    _WRAPPED = {"all_reduce": "all-reduce", "all_gather": "all-gather",
                "all_gather_into_tensor": "all-gather",
                "all_to_all_single": "all-to-all",
                "reduce_scatter": "reduce-scatter",
                "reduce_scatter_tensor": "reduce-scatter"}

    def __init__(self):
        self.events: list[tuple[str, tuple, torch.dtype, int, int]] = []
        self.scale = 1
        self._saved: dict[str, Any] = {}

    def __enter__(self):
        for name, kind in self._WRAPPED.items():
            self._saved[name] = fn = getattr(dist, name)
            setattr(dist, name, self._wrap(fn, name, kind))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        self._saved.clear()

    @contextlib.contextmanager
    def repeated(self, n: int):
        """Count every collective recorded in the block ``n`` times (a
        replay standing for ``n`` identical calls)."""
        outer, self.scale = self.scale, self.scale * n
        try:
            yield
        finally:
            self.scale = outer

    def record(self, kind: str, shape, dtype: torch.dtype, group_size: int,
               count: int = 1) -> None:
        if count * self.scale and group_size > 1:
            self.events.append((kind, tuple(int(d) for d in shape), dtype,
                                group_size, count * self.scale))

    def _wrap(self, fn, name: str, kind: str):
        def recorded(a, b=None, *args, **kwargs):
            group = kwargs.get("group")
            n = dist.get_world_size(group)
            if name == "all_reduce":
                shape, dtype = a.shape, a.dtype
            elif name == "all_gather":                 # (list, tensor)
                shape, dtype = (len(a) * b.shape[0], *b.shape[1:]), b.dtype
            else:                                      # (output, input)
                shape, dtype = a.shape, a.dtype
            self.record(kind, shape, dtype, n)
            if b is None:
                return fn(a, *args, **kwargs)
            return fn(a, b, *args, **kwargs)
        return recorded

    def hlo_text(self) -> str:
        """One HLO-style line per collective, with its result shape."""
        lines = []
        for i, (kind, shape, dtype, n, count) in enumerate(self.events):
            text = (f"{_DTYPE_NAMES[dtype]}[{','.join(map(str, shape))}] "
                    f"{kind}(), group_size={n}")
            lines += [f"  %{kind}.{i}.{j} = {text}" for j in range(count)]
        return "\n".join(lines)


@contextlib.contextmanager
def fake_world(n: int):
    """Rank 0 of an ``n``-rank process group on the ``"fake"`` backend,
    for the block (closed after).  Its collectives do nothing and accept
    ``meta`` tensors."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is open already")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()

