"""Mesh construction (PyTorch port of ``repro.launch.mesh``).

Axis roles: ``pod`` (inter-pod DCN-ish axis), ``data`` (intra-pod data
parallel), ``model`` (tensor/expert parallel).  Each mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process group,
built by a function call, so importing this module touches no device and no
process group.  Rank r sits at the row-major coordinate of r, which is how
``jax.make_mesh`` lays out host devices: rank r and JAX device r hold the
same shard of every spec (``distributed.sharding.named``).

``axis_group`` is the process group of a rank's neighbours along some axes
of a mesh (its row, its column, or a plane of them), what a collective over
those axis names reduces or exchanges across.  A group over two or more
axes orders its ranks with the first axis major, as a JAX collective over a
tuple of axis names does.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the default
    process group, which must have exactly ``prod(shape)`` ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {shape} mesh needs an initialised torch.distributed process "
            "group (init_process_group) of that many ranks")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks; the process group "
                         f"has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).view(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) = 256 ranks on one pod; (2, 16, 16) = 512 ranks over two
    pods."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


def make_debug_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """Tiny mesh with the same axis roles: (2, 4), or (2, 2, 2)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type=device_type)


@contextlib.contextmanager
def one_rank_mesh(device_type: str = "cuda"):
    """A (1, 1) mesh with axes ("data", "model") for the block: over a
    one-rank process group opened here (NCCL on the card, gloo on the CPU)
    and closed after, or over the default group if one is open already."""
    opened = not (dist.is_available() and dist.is_initialized())
    if opened:
        kw = {}
        if device_type == "cuda":
            kw["device_id"] = torch.device("cuda",
                                           torch.cuda.current_device())
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    try:
        yield make_mesh((1, 1), ("data", "model"), device_type=device_type)
    finally:
        if opened:
            dist.destroy_process_group()


def axis_group(mesh, axes: str | tuple[str, ...] | None = None):
    """The process group of this rank and its neighbours along ``axes``
    of ``mesh`` (every axis when None), ranked with the first axis major.

    One named axis is the mesh's own group for it.  Several axes make one
    group per combination of the other axes' coordinates (every rank must
    call this, in the same order, as for any group creation); the groups are
    cached on the mesh, so later calls are free."""
    names = tuple(mesh.mesh_dim_names)
    axes = names if axes is None else (
        (axes,) if isinstance(axes, str) else tuple(axes))
    cache = mesh.__dict__.setdefault("_axis_groups", {})
    if axes in cache:
        return cache[axes]
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    else:
        dims = [names.index(a) for a in axes]
        rest = [i for i in range(len(names)) if i not in dims]
        size = math.prod(mesh.mesh.shape[i] for i in dims)
        rows = mesh.mesh.permute(*rest, *dims).reshape(-1, size).tolist()
        # A group ranks its members in ascending order; the rows must
        # already be ascending for that order to be the first-axis-major one.
        if any(r != sorted(r) for r in rows):
            raise ValueError(f"mesh ranks along {axes} are not ascending "
                             "first-axis-major; build the mesh with "
                             "make_mesh")
        group, _ = dist.new_subgroups_by_enumeration(rows)
    cache[axes] = group
    return group
