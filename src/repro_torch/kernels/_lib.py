"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``.  A build
happens at first use, into ``build/repro_torch/`` at the repository root,
under a file name keyed by a hash of the source and the flags, so a changed
source rebuilds and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Each kernel's ``kernel.py`` also holds its cost formula (``cost``): the
operations and the bytes one call needs, the formula behind the bound that
``PERF.md`` §6 gives it.  While a counter is active (``COUNTER``, set by
``launch.trace.Counter``) every binding reports its call's ``Cost`` to it,
on the card and on ``meta`` alike; a binding given ``meta`` tensors checks
them as it would CUDA ones and returns an empty output of the kernel's
shape and dtype, launching nothing.

Nothing here runs at import: the CPU tests import every module, and this
machine need not have ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.spans import RECORDER

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


class Cost(NamedTuple):
    """What one kernel call must do: ``flops`` operations and ``bytes`` of
    device memory (each input read once, each output written once).  The
    operations run at the fp32 rate of the CUDA cores (``fp32``) or, for
    bf16 operands, at the tensor cores' bf16 rate."""

    flops: float
    bytes: float
    fp32: bool = True


# The active cost counter, or None.  A binding reads it once a call and
# computes its ``Cost`` only when it is set, so a call with no counter pays
# one module attribute lookup.
COUNTER = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the repro_torch CUDA kernels")


def _c_arg(a):
    """One launch argument as its ctypes value: a tensor as its data
    pointer and None as a null one, a Python float as a C ``float`` (a
    kernel's tolerance), any other value as a C ``int``."""
    if isinstance(a, torch.Tensor):
        return ctypes.c_void_p(a.data_ptr())
    if a is None:
        return ctypes.c_void_p(None)
    if isinstance(a, float):
        return ctypes.c_float(a)
    return ctypes.c_int(int(a))


class Kernel:
    """One ``.cu`` source: its library, its C entry points and the count of
    launches made through ``launch``.  Each launch is a device span
    ``kernel.<name>`` of ``repro_torch.spans`` under the span open at the
    time (none outside a request)."""

    def __init__(self, name: str):
        self.name = name
        self.span_name = f"kernel.{name}"
        self.source = CSRC / f"{name}.cu"
        self.launches = 0
        self._lib: ctypes.CDLL | None = None
        # Entry point -> the argument types its prototype was last set for.
        self._prototypes: dict[str, tuple] = {}

    @property
    def _stem(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes()
                           + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.name}-{h}"

    @property
    def library(self) -> Path:
        return self._stem.with_suffix(".so")

    @property
    def build_log(self) -> Path:
        """nvcc's output for the current library (``-Xptxas -v``:
        registers, shared memory and spills of each kernel)."""
        return self._stem.with_suffix(".log")

    def _start_build(self) -> tuple | None:
        """Start nvcc unless the library exists; returns what
        ``_finish_build`` needs."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        log = open(self.build_log, "w")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(self.source)],
                                stdout=log, stderr=subprocess.STDOUT)
        return proc, log, tmp

    def _finish_build(self, started: tuple | None) -> None:
        if started is None:
            return
        proc, log, tmp = started
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(rc={rc}):\n{self.build_log.read_text()}")
        os.replace(tmp, self.library)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self._finish_build(self._start_build())
            self._lib = ctypes.CDLL(str(self.library))
        return self._lib

    def launch(self, fn: str, *args,
               stream: torch.cuda.Stream | None = None) -> None:
        """Call C entry point ``fn`` on ``stream`` (by default the current
        stream; a kernel that keeps state per stream passes the one it
        keyed it by).  Arguments are tensors (passed as device pointers),
        None (a null pointer), Python floats (passed as C ``float``) or
        ints; the stream goes last.  The entry point's ctypes prototype is
        set on its first call and again only when the argument types
        change.  Raises if the launch was refused."""
        lib = self.load()
        cargs = [_c_arg(a) for a in args]
        if stream is None:
            stream = torch.cuda.current_stream()
        cargs.append(ctypes.c_void_p(stream.cuda_stream))
        f = getattr(lib, fn)
        types = tuple(type(c) for c in cargs)
        if self._prototypes.get(fn) != types:
            f.argtypes = list(types)
            f.restype = ctypes.c_int
            self._prototypes[fn] = types
        with RECORDER.span(self.span_name, device=stream):
            rc = f(*cargs)
        if rc != 0:
            raise RuntimeError(f"{self.name}.{fn} launch failed: CUDA error "
                               f"{rc}")
        self.launches += 1


SIMILARITY = Kernel("similarity")
KNN_SCORE = Kernel("knn_score")
LIST_MERGE = Kernel("list_merge")
TWIN_PROBE = Kernel("twin_probe")
VERIFY_ROWS = Kernel("verify_rows")
EMBEDDING_BAG = Kernel("embedding_bag")
KEY_DEDUP = Kernel("key_dedup")
KERNELS = {k.name: k for k in (SIMILARITY, KNN_SCORE, LIST_MERGE, TWIN_PROBE,
                               VERIFY_ROWS, EMBEDDING_BAG, KEY_DEDUP)}


def build_all() -> dict[str, str]:
    """Build every kernel library at once (one ``nvcc`` per source, all
    started together); returns each kernel's build log."""
    procs = {name: k._start_build() for name, k in KERNELS.items()}
    for name, k in KERNELS.items():
        k._finish_build(procs[name])
    for k in KERNELS.values():
        k.load()
    return {name: k.build_log.read_text() if k.build_log.exists() else ""
            for name, k in KERNELS.items()}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
