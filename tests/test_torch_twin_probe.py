"""Port parity: the twin-probe intersection's wrapper against the JAX
reference.

The same numpy inputs go to ``repro.kernels.twin_probe`` (its Pallas kernel
in interpret mode, the JAX wrapper's default) and to
``repro_torch.kernels.twin_probe`` on the CPU (the plain version).  Mask and
count must match exactly.  The JAX wrapper pads N to 512 with -3.0 and
counts the padding too, so its count can exceed the mask's for tol >= 2;
the cases stay below that (ROADMAP Queue 3).  The kernel itself is held to
its plain version on the card in ``test_torch_gpu.py``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import twin_probe as jtwin_probe
from repro.kernels.twin_probe.ref import twin_probe_ref as jref
from repro_torch.kernels import launch_counts, twin_probe
from tests.hypcompat import given, settings, st

torch.set_num_threads(2)


def _assert_parity(rows, s0, tol):
    before = launch_counts()["twin_probe"]
    mask, count = twin_probe(torch.as_tensor(rows), torch.as_tensor(s0),
                             tol=tol)
    assert launch_counts()["twin_probe"] == before     # plain version ran
    assert mask.dtype == torch.bool and mask.shape == (rows.shape[1],)
    assert count.dtype == torch.int32 and count.shape == ()
    jmask, jcount = jtwin_probe(jnp.asarray(rows), jnp.asarray(s0), tol=tol)
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert int(count) == int(jcount) == int(mask.sum())
    rmask, rcount = jref(jnp.asarray(rows), jnp.asarray(s0), tol)
    assert np.array_equal(mask.numpy(), np.asarray(rmask))
    assert int(count) == int(rcount)
    return mask


@pytest.mark.parametrize("c,N", [(2, 64), (8, 700), (16, 2048), (8, 513)])
def test_twin_probe_sweep_parity(c, N):
    """The shapes of ``tests/test_kernels.py``'s sweep, N = 700 and 513 not
    multiples of the JAX block width."""
    rng = np.random.default_rng(c * N)
    rows = rng.uniform(0, 1, (c, N)).astype(np.float32)
    s0 = rows[:, N // 3].copy()
    mask = _assert_parity(rows, s0, 1e-6)
    assert mask[N // 3]


def test_twin_probe_ties_edges_and_nan():
    """Values exactly tol away in fp32 and one ulp beyond, duplicated
    columns, NaN in a row and in s0, and SENTINEL columns."""
    c, N = 4, 300
    rng = np.random.default_rng(7)
    rows = np.round(rng.uniform(-1, 1, (c, N)), 2).astype(np.float32)
    s0 = rows[:, 5].copy()
    rows[:, 6] = s0                                   # exact duplicate
    rows[:, 7] = s0 + np.float32(1e-6)                # at the edge
    rows[:, 8] = np.nextafter(s0 + np.float32(1e-6), np.float32(2))
    rows[:, 9] = s0
    rows[2, 9] = np.nan                               # NaN never matches
    rows[:, 10:20] = -2.0                             # SENTINEL slots
    _assert_parity(rows, s0, 1e-6)
    s0_nan = s0.copy()
    s0_nan[1] = np.nan
    mask = _assert_parity(rows, s0_nan, 1e-6)
    assert not mask.any()


@pytest.mark.parametrize("tol", [0.0, 0.05, 1.5])
def test_twin_probe_tolerances(tol):
    rng = np.random.default_rng(3)
    rows = np.round(rng.uniform(-1, 1, (3, 520)), 1).astype(np.float32)
    _assert_parity(rows, rows[:, 11].copy(), tol)


def test_twin_probe_promotes_like_jnp():
    """float16 rows against float32 probe sims compare in float32 on both
    sides."""
    rng = np.random.default_rng(4)
    rows = rng.uniform(0, 1, (3, 100)).astype(np.float16)
    s0 = rows[:, 2].astype(np.float32)
    s0[0] += np.float32(4e-4)             # moved by more than tol
    mask = _assert_parity(rows, s0, 1e-4)
    assert not mask[2]


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 9), st.integers(1, 1100))
def test_property_twin_probe_any_shape(seed, c, N):
    rng = np.random.default_rng(seed)
    rows = np.round(rng.uniform(-1, 1, (c, N)), 1).astype(np.float32)
    _assert_parity(rows, rows[:, int(rng.integers(N))].copy(), 1e-6)


def test_kernel_launch_passes_floats_as_c_float(monkeypatch):
    """A Python float reaches the C entry point as ``float`` (so tol = 1e-6
    is not cut to the int 0); tensors go as pointers and ints as ``int``,
    with the stream last."""
    import ctypes
    import types

    from repro_torch.kernels import _lib

    seen = {}

    def entry(*cargs):
        seen["args"] = cargs
        return 0

    kernel = _lib.Kernel("twin_probe")
    monkeypatch.setattr(kernel, "load",
                        lambda: types.SimpleNamespace(twin_probe_f32=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    t = torch.zeros(3)
    kernel.launch("twin_probe_f32", t, 1e-6, 5)
    assert entry.argtypes == [ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                              ctypes.c_void_p]
    ptr, tol, n, _ = seen["args"]
    assert ptr.value == t.data_ptr()
    assert tol.value == float(np.float32(1e-6)) and n.value == 5
    assert kernel.launches == 1


def test_kernel_launch_sets_prototype_once_per_argument_types(monkeypatch):
    """The ctypes prototype is set on an entry point's first call, kept
    while the argument types stay the same, and set anew when they
    change."""
    import ctypes
    import types

    from repro_torch.kernels import _lib

    class Entry:
        def __init__(self):
            object.__setattr__(self, "set_to", [])

        def __setattr__(self, key, value):
            if key == "argtypes":
                self.set_to.append(list(value))
            object.__setattr__(self, key, value)

        def __call__(self, *cargs):
            return 0

    entry = Entry()
    kernel = _lib.Kernel("twin_probe")
    monkeypatch.setattr(kernel, "load",
                        lambda: types.SimpleNamespace(twin_probe_f32=entry))
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    t = torch.zeros(3)
    p, f, i = ctypes.c_void_p, ctypes.c_float, ctypes.c_int
    kernel.launch("twin_probe_f32", t, 1e-6, 5)
    kernel.launch("twin_probe_f32", t, 0.5, 7)
    assert entry.set_to == [[p, f, i, p]]
    kernel.launch("twin_probe_f32", t, 2, 7)        # an int for the float
    assert entry.set_to == [[p, f, i, p], [p, i, i, p]]
    kernel.launch("twin_probe_f32", t, 3, 9)
    assert len(entry.set_to) == 2
    assert entry.restype is ctypes.c_int and kernel.launches == 4


@pytest.mark.parametrize("c,N", [(1, 515), (1, 1024), (8, 1027), (8, 4096),
                                 (9, 1026), (9, 4099), (4, 258), (16, 777)])
def test_twin_probe_probe_counts_and_ragged_widths(c, N):
    """The kernel's instantiated probe counts (4, 8, 16) and run-time ones
    (1, 9), at N divisible by 4 and not: exact twins, values at the
    tolerance's edge and one ulp beyond (either side of it after fp32
    rounding, as in jnp), NaN and SENTINEL columns in the last, ragged
    group of four."""
    rng = np.random.default_rng(c * 7919 + N)
    rows = np.round(rng.uniform(-1, 1, (c, N)), 2).astype(np.float32)
    s0 = rows[:, N // 2].copy()
    tol = np.float32(0.01)
    for x in (N - 1, N - 5, 0):
        rows[:, x] = s0                              # exact twins
    rows[:, N - 2] = s0 + tol                        # at the edge
    rows[:, N - 3] = np.nextafter(s0 + tol, np.float32(2))
    rows[c - 1, N - 4] = np.nan
    rows[:, N - 6] = -2.0                            # SENTINEL
    mask = _assert_parity(rows, s0, float(tol))
    assert mask[N - 1] and mask[N - 5] and mask[0]
    assert not mask[N - 4] and not mask[N - 6]


@pytest.mark.parametrize("case", ["cpu", "shape", "dtype"])
def test_kernel_binding_refuses_before_launch(case):
    """``twin_probe_cuda`` checks shapes, dtypes and the device in Python,
    before any pointer reaches the kernel."""
    from repro_torch.kernels.twin_probe.kernel import twin_probe_cuda
    rows, s0 = torch.zeros((3, 8)), torch.zeros(3)
    if case == "shape":
        s0 = torch.zeros(2)
    elif case == "dtype":
        rows = rows.double()
    before = launch_counts()["twin_probe"]
    with pytest.raises(TypeError if case == "dtype" else ValueError):
        twin_probe_cuda(rows, s0, 1e-6)
    assert launch_counts()["twin_probe"] == before
