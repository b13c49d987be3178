"""Device meshes and batch sharding.

The port's counterpart of ``generative_physics_informed_pde_tpu/parallel/
mesh.py``.  PyTorch runs one process per device, so a mesh of more than
one device is a ``torch.distributed.device_mesh.DeviceMesh`` over the
processes of the group, and sharding a batch means that each process
keeps its own contiguous rows (``shard_data_dict``).  A one-device mesh is
a ``LocalMesh`` of the caller's device, which needs no process group.

Sharded training (``replicated``, ``batch_sharding``,
``mc_batch_sharding``, ``shard_train_state``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
from torch.utils import _pytree

from ..utils.device import resolve_device
from .distributed import all_gather_rows, process_count


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of this process's one device (``DeviceMesh``'s attributes
    that the port reads: ``device_type``, ``mesh_dim_names``, ``shape``,
    ``size()``)."""

    device: torch.device
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def device_type(self) -> str:
        return self.device.type

    def size(self) -> int:
        return 1


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None, device="cuda"):
    """A mesh over ``n_devices`` devices (default: one a process of the
    group, or this process's device when no group is up), with the axes
    ``axis_names`` of ``shape`` (default: all devices on the first axis),
    e.g. ``make_mesh(4, ("dp", "mc"), (2, 2))``.  One device gives a
    ``LocalMesh`` of ``device``; more give a ``DeviceMesh`` over the
    group's processes, which then must be all of them.  Asking for more
    devices than there are processes raises ValueError."""
    dev = resolve_device(device)
    n_avail = process_count()
    if n_devices is not None and n_devices > n_avail:
        raise ValueError(f"requested {n_devices} devices, have {n_avail} "
                         "(one a process)")
    n = n_avail if n_devices is None else n_devices
    axis_names = tuple(axis_names)
    shape = (n,) + (1,) * (len(axis_names) - 1) if shape is None \
        else tuple(shape)
    if math.prod(shape) != n or len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} over axes {axis_names} does "
                         f"not hold {n} devices")
    if n == 1:
        return LocalMesh(dev, axis_names, shape)
    if n != n_avail:
        raise ValueError(f"a mesh of {n} devices in a group of {n_avail} "
                         "processes: use 1 (this process) or all of them")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axis_names)


def _mesh_device(mesh) -> torch.device:
    """The device this process holds of ``mesh``."""
    if isinstance(mesh, LocalMesh):
        return mesh.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_pspec(mesh, axis: str = "dp") -> Tuple[str, ...]:
    """The mesh axes the batch (leading) dimension is split over:
    ``(axis,)``.  An ``axis`` the mesh does not have is an error (a typo
    here would otherwise silently run with the wrong data
    distribution)."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return (axis,)


def shard_data_dict(data, mesh, axis: str = "dp"):
    """Every array in a (nested) data dict as a tensor on this process's
    device of ``mesh``, holding this process's contiguous rows: on a mesh
    of ``k`` devices along ``axis``, the ``i``-th block of ``N / k`` rows,
    ``i`` the process's coordinate on ``axis``.  0-d leaves and leaves
    whose leading dimension does not divide by ``k`` are kept whole
    (replicated), and so is everything on a one-device mesh."""
    (ax,) = batch_pspec(mesh, axis)
    dev = _mesh_device(mesh)
    k = mesh.shape[mesh.mesh_dim_names.index(ax)]
    i = 0 if k == 1 else mesh.get_local_rank(ax)

    def put(x):
        x = torch.as_tensor(x, device=dev)
        if k == 1 or x.ndim == 0 or x.shape[0] % k:
            return x
        per = x.shape[0] // k
        return x[i * per:(i + 1) * per]

    return _pytree.tree_map(put, data)


def gather_batch(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """The inverse of ``shard_data_dict`` for one sharded tensor: every
    process's rows along ``axis``, concatenated in coordinate order, on
    every process; ``x`` itself on a mesh of one device along ``axis``."""
    (ax,) = batch_pspec(mesh, axis)
    if mesh.shape[mesh.mesh_dim_names.index(ax)] == 1:
        return x
    return all_gather_rows(x, group=mesh.get_group(ax))
