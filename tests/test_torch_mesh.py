"""Port parity of ``repro_torch.launch.mesh`` against
``repro.launch.mesh``, on a fake process group (``FakeStore``, the
``"fake"`` backend of ``torch.testing._internal``, a private test helper:
its collectives do nothing, which building a mesh does not need).

  * ``make_production_mesh`` ((16, 16) on 256 ranks, (2, 16, 16) on 512)
    and ``make_debug_mesh`` ((2, 4) and (2, 2, 2) on 8) give the
    reference's shapes and axis names, rank r at the row-major coordinate
    of r, and ``mesh_axes`` of each equals the reference's ``mesh_axes``
    of the JAX mesh with that shape and those names (built with
    ``jax.sharding.Mesh`` over one repeated CPU device: ``mesh_axes`` reads
    only names and shape).
  * The constructors raise without a process group or with a group of the
    wrong size, and default to the card.
  * ``axis_group`` over two axes orders its ranks first-axis-major.
  * Importing the module opens no process group and touches no device, in
    a fresh interpreter.
"""
from __future__ import annotations

import inspect
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax

from repro.distributed import sharding as jshd
from repro_torch.distributed import sharding as tshd
from repro_torch.launch import mesh as tmesh

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CASES = [("production", False, 256, (16, 16), ("data", "model")),
         ("production", True, 512, (2, 16, 16), ("pod", "data", "model")),
         ("debug", False, 8, (2, 4), ("data", "model")),
         ("debug", True, 8, (2, 2, 2), ("pod", "data", "model"))]


@pytest.fixture
def fake_group():
    """A fake process group of the given size in this process, torn down
    after."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def open_(world: int, rank: int = 0):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


def _jax_mesh(shape, names):
    dev = np.array([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return jax.sharding.Mesh(dev, names)


@pytest.mark.parametrize("kind,multi_pod,world,shape,names", CASES)
def test_meshes_match_the_reference(fake_group, kind, multi_pod, world,
                                    shape, names):
    fake_group(world, rank=world - 1)
    make = {"production": tmesh.make_production_mesh,
            "debug": tmesh.make_debug_mesh}[kind]
    mesh = make(multi_pod=multi_pod, device_type="cpu")
    assert tuple(mesh.mesh.shape) == shape
    assert tuple(mesh.mesh_dim_names) == names
    assert torch.equal(mesh.mesh, torch.arange(world).view(shape))
    assert tuple(mesh.get_coordinate()) == tuple(
        int(i) for i in np.unravel_index(world - 1, shape))
    got = tshd.mesh_axes(mesh)
    want = jshd.mesh_axes(_jax_mesh(shape, names))
    assert (got.dp, got.mp, got.sizes) == (want.dp, want.mp, want.sizes)
    assert (got.all, got.mp_size, got.dp_size) == (want.all, want.mp_size,
                                                   want.dp_size)


def test_constructors_default_to_the_card_and_check_the_group(fake_group):
    for fn in (tmesh.make_production_mesh, tmesh.make_debug_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == \
            "cuda"
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_debug_mesh(device_type="cpu")
    fake_group(16)
    with pytest.raises(ValueError, match="needs 8 ranks"):
        tmesh.make_debug_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh(device_type="cpu")


@pytest.mark.parametrize("rank", [0, 5])
def test_axis_group_is_first_axis_major(fake_group, rank):
    fake_group(8, rank=rank)
    mesh = tmesh.make_debug_mesh(multi_pod=True, device_type="cpu")
    model = mesh.mesh.shape[2]
    g = tmesh.axis_group(mesh, ("pod", "data"))
    coord = mesh.get_coordinate()
    want = [int(mesh.mesh[p, d, coord[2]]) for p in range(2)
            for d in range(2)]
    assert dist.get_process_group_ranks(g) == want
    assert want == [coord[2] + model * i for i in range(4)]
    assert tmesh.axis_group(mesh, ("pod", "data")) is g       # cached
    assert dist.get_process_group_ranks(tmesh.axis_group(mesh)) == list(
        range(8))
    assert dist.get_process_group_ranks(
        tmesh.axis_group(mesh, "model")) == [
            int(mesh.mesh[coord[0], coord[1], m]) for m in range(2)]


def test_import_touches_no_process_group_or_device():
    code = ("import sys, torch.distributed as dist\n"
            "import repro_torch.launch.mesh as m\n"
            "import repro_torch.models.moe_ep\n"
            "import repro_torch.distributed.sharding\n"
            "assert not dist.is_initialized()\n"
            "import torch\n"
            "assert not torch.cuda.is_initialized()\n"
            "bad = sorted(x for x in sys.modules\n"
            "             if x.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
