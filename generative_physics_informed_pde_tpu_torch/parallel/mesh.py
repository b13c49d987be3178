"""Device meshes, shardings and the sharded training state.

The port's counterpart of ``generative_physics_informed_pde_tpu/parallel/
mesh.py``.  PyTorch runs one process per device, so a mesh of more than
one device is a ``ProcessMesh`` over the processes of the group (rank
``i`` at the ``i``-th place of the mesh in row-major order), and a
sharded tensor is a plain local tensor that holds this process's
contiguous rows.  A one-device mesh is a ``LocalMesh`` of the caller's
device, which needs no process group.

A sharding (``replicated``, ``batch_sharding``, ``mc_batch_sharding``) is
a ``Sharding``: the mesh and the axes that split the leading dimension
jointly, the first axis major (JAX's ``PartitionSpec`` of the leading
dimension).  ``shard_train_state`` keeps this process's rows of the
per-datapoint parameter blocks and their Adam moments, and leaves the
rest whole, as the JAX package's does with its ``TrainState``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree

from ..utils.device import resolve_device
from .distributed import all_gather_rows, process_count, process_index


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """A mesh of this process's one device (``ProcessMesh``'s attributes:
    ``device``, ``device_type``, ``mesh_dim_names``, ``shape``,
    ``size()``, ``get_coordinate()``)."""

    device: torch.device
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def device_type(self) -> str:
        return self.device.type

    def size(self) -> int:
        return 1

    def get_coordinate(self) -> Tuple[int, ...]:
        return (0,) * len(self.shape)


class ProcessMesh:
    """A mesh over all processes of the group: axes ``mesh_dim_names`` of
    ``shape``, rank ``i`` at the ``i``-th place in row-major order (so
    the first axis is the slowest).  Each process computes on ``device``.
    ``group(axes)`` is the process group of the processes that differ
    from this one only along ``axes`` (None for one process)."""

    def __init__(self, device: torch.device, mesh_dim_names, shape):
        self.device = device
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.shape = tuple(int(s) for s in shape)
        self.mesh = torch.arange(math.prod(self.shape)).reshape(self.shape)
        self._groups = {}
        for name in self.mesh_dim_names:  # every process builds them all
            self.group((name,))

    @property
    def device_type(self) -> str:
        return self.device.type

    def size(self) -> int:
        return math.prod(self.shape)

    def coordinate_of(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(c) for c in torch.unravel_index(
            torch.tensor(rank), self.shape))

    def get_coordinate(self) -> Tuple[int, ...]:
        return self.coordinate_of(process_index())

    def group(self, axes: Sequence[str]):
        """The process group along ``axes`` that holds this process (the
        default group when ``axes`` span the mesh; None when it holds
        this process alone).  Built the first time for every place of the
        other axes at once: every process must ask in the same order."""
        axes = tuple(axes)
        dims = [self.mesh_dim_names.index(a) for a in axes]
        if math.prod(self.shape[d] for d in dims) == 1:
            return None
        if len(set(dims)) == len(self.shape):
            return dist.group.WORLD
        if axes not in self._groups:
            rest = [d for d in range(len(self.shape)) if d not in dims]
            blocks = self.mesh.permute(rest + sorted(dims)).reshape(
                -1, math.prod(self.shape[d] for d in dims))
            mine = None
            for ranks in blocks.tolist():
                g = dist.new_group(sorted(ranks))
                if process_index() in ranks:
                    mine = g
            self._groups[axes] = mine
        return self._groups[axes]

    def __repr__(self):
        return (f"ProcessMesh({self.device_type}, "
                f"{dict(zip(self.mesh_dim_names, self.shape))})")


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp",),
              shape: Optional[Sequence[int]] = None, device="cuda"):
    """A mesh over ``n_devices`` devices (default: one a process of the
    group, or this process's device when no group is up), with the axes
    ``axis_names`` of ``shape`` (default: all devices on the first axis),
    e.g. ``make_mesh(4, ("dp", "mc"), (2, 2))``.  One device gives a
    ``LocalMesh`` of ``device``; more give a ``ProcessMesh`` over the
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
    return ProcessMesh(dev, axis_names, shape)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor's leading dimension lies on ``mesh``: split in equal
    contiguous blocks over the mesh ``axes`` jointly (the first of
    ``axes`` major), whole on every place of the other axes; no axes is
    replicated.  Only ``mesh_dim_names`` and ``shape`` of the mesh are
    read to place rows, so the rows of any coordinate can be asked
    for."""

    mesh: object
    axes: Tuple[str, ...]

    def _dims(self):
        names = tuple(self.mesh.mesh_dim_names)
        return [names.index(a) for a in self.axes]

    @property
    def num_shards(self) -> int:
        return math.prod(self.mesh.shape[d] for d in self._dims())

    def shard_index(self, coordinate=None) -> int:
        """The block of the process at ``coordinate`` (default: this
        process's)."""
        if coordinate is None:
            coordinate = self.mesh.get_coordinate()
        index = 0
        for d in self._dims():
            index = index * self.mesh.shape[d] + int(coordinate[d])
        return index

    def rows(self, n: int, coordinate=None) -> slice:
        """The rows of a length-``n`` leading dimension that the process at
        ``coordinate`` (default: this process) holds."""
        k = self.num_shards
        if n % k:
            raise ValueError(f"{n} rows do not split over the {k} shards "
                             f"of mesh axes {self.axes}")
        per = n // k
        i = self.shard_index(coordinate)
        return slice(i * per, (i + 1) * per)

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``x``."""
        return x if self.num_shards == 1 else x[self.rows(x.shape[0])]

    def group(self):
        """The process group of the processes holding the other blocks of
        this process's copy (None when it holds them all)."""
        if isinstance(self.mesh, LocalMesh) or self.num_shards == 1:
            return None
        return self.mesh.group(self.axes)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole leading dimension from every process's block ``x``,
        on every process (the inverse of ``shard``)."""
        g = self.group()
        if g is None:
            return x
        parts = all_gather_rows(x, group=g).reshape(
            (self.num_shards,) + tuple(x.shape))
        # the group's ranks ascend; order their blocks by shard index
        ranks = sorted(int(r) for r in self._group_ranks())
        order = [self.shard_index(self.mesh.coordinate_of(r))
                 for r in ranks]
        out = torch.empty_like(parts)
        out[torch.tensor(order, device=x.device)] = parts
        return out.reshape((-1,) + tuple(x.shape[1:]))

    def _group_ranks(self):
        coord = list(self.mesh.get_coordinate())
        idx = [slice(None) if d in self._dims() else coord[d]
               for d in range(len(self.mesh.shape))]
        return self.mesh.mesh[tuple(idx)].flatten().tolist()


def replicated(mesh) -> Sharding:
    """Whole on every device of ``mesh``."""
    return Sharding(mesh, ())


def batch_pspec(mesh, axis: str = "dp") -> Tuple[str, ...]:
    """The mesh axes the batch (leading) dimension is split over:
    ``(axis,)``, or ``('dcn', axis)`` on a hybrid mesh of
    ``make_hybrid_mesh``, whose batch crosses the nodes along 'dcn' and a
    node's processes along ``axis`` (process-major, as
    ``local_shard_slice``).  An ``axis`` the mesh does not have is an
    error (a typo here would otherwise silently run with the wrong data
    distribution)."""
    names = tuple(mesh.mesh_dim_names)
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    if "dcn" in names and axis != "dcn":
        return ("dcn", axis)
    return (axis,)


def batch_sharding(mesh, axis: str = "dp") -> Sharding:
    """The leading dimension split over ``axis`` (and 'dcn' first on
    hybrid meshes)."""
    return Sharding(mesh, batch_pspec(mesh, axis))


def mc_batch_sharding(mesh) -> Sharding:
    """The leading dimension split over ALL mesh axes jointly: for the
    flattened (N * n_mc) Monte-Carlo ELBO batch on a ("dp", "mc") mesh the
    sample-major flat axis is split dp-major, so each dp block keeps its
    data samples and 'mc' subdivides their Monte-Carlo replicates."""
    return Sharding(mesh, tuple(mesh.mesh_dim_names))


def shard_data_dict(data, mesh, axis: str = "dp"):
    """Every array in a (nested) data dict as a tensor on this process's
    device of ``mesh``, holding this process's rows under
    ``batch_sharding(mesh, axis)``: the batch split over every axis
    ``batch_pspec`` names, jointly and process-major.  0-d leaves and
    leaves whose leading dimension does not divide by the shard count
    are kept whole (replicated), and so is everything on a one-device
    mesh."""
    sh = batch_sharding(mesh, axis)
    dev = mesh.device
    k = sh.num_shards

    def put(x):
        x = torch.as_tensor(x, device=dev)
        if k == 1 or x.ndim == 0 or x.shape[0] % k:
            return x
        return sh.shard(x)

    return _pytree.tree_map(put, data)


def gather_batch(x: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """The inverse of ``shard_data_dict`` for one sharded tensor: every
    process's rows along the batch axes, in block order, on every
    process; ``x`` itself on a mesh of one block."""
    return batch_sharding(mesh, axis).gather(x)


# The JAX package's per-datapoint TrainState paths and the port's tensors
# they name:
#   "q_z"          GenerativeModel.q_z[name]["mean" / "logsigma"] (every
#                  modality) and their moments in the trainer's Adam; in a
#                  checkpoint the "model" entries "q_z.<name>.<field>" and
#                  the "optimizer" states of those parameters
#   "q_X"          GenerativeModel.q_X[...], likewise
#   "pe_q"         the prediction ensemble's q["mean" / "logsigma"]
#                  ("prediction_ensemble" / "q" in a checkpoint)
#   "pe_opt_state" the moments of its Adam ("prediction_ensemble" /
#                  "optimizer" / "state")
DATA_INDEXED = ("q_z", "q_X", "pe_q", "pe_opt_state")
_MODEL_BLOCKS = ("q_z", "q_X")


def _cut_state(state: dict, cut):
    """Adam's per-parameter ``state`` entries with ``cut`` applied to each
    tensor of at least one dimension (the moments; not the step)."""
    return {k: (cut(v) if isinstance(v, torch.Tensor) and v.ndim >= 1
                else v) for k, v in state.items()}


def _model_block(name: str, data_indexed) -> bool:
    """Whether the model parameter or buffer ``name`` is a per-datapoint
    block named in ``data_indexed``."""
    head = name.split(".", 1)[0]
    return head in _MODEL_BLOCKS and head in data_indexed


def map_state_blocks(state: dict, fn, data_indexed=DATA_INDEXED) -> dict:
    """A state dict as ``Trainer.save_checkpoint`` writes it, with ``fn``
    applied to each tensor of the per-datapoint blocks named in
    ``data_indexed`` (and of their Adam moments); the rest as it is."""
    state = dict(state)
    names = state["param_names"]
    state["model"] = {k: (fn(v) if _model_block(k, data_indexed) else v)
                      for k, v in state["model"].items()}
    opt = dict(state["optimizer"])
    opt["state"] = {i: (_cut_state(s, fn)
                        if _model_block(names[i], data_indexed) else s)
                    for i, s in opt["state"].items()}
    state["optimizer"] = opt
    pe = dict(state["prediction_ensemble"])
    if "pe_q" in data_indexed:
        pe["q"] = {k: fn(v) for k, v in pe["q"].items()}
    if "pe_opt_state" in data_indexed:
        pe_opt = dict(pe["optimizer"])
        pe_opt["state"] = {i: _cut_state(s, fn)
                           for i, s in pe_opt["state"].items()}
        pe["optimizer"] = pe_opt
    state["prediction_ensemble"] = pe
    return state


def shard_train_state(trainer_or_state, mesh, axis: str = "dp",
                      data_indexed=DATA_INDEXED):
    """Keep this process's rows (``batch_sharding(mesh, axis)``) of the
    per-datapoint parameter blocks named in ``data_indexed`` -- and of the
    Adam moments that mirror them -- and everything else whole, as the
    JAX package's ``shard_train_state`` places a ``TrainState``.

    ``trainer_or_state``: a set-up ``Trainer``, whose blocks are replaced
    by parameters of their local rows (its optimizers' states follow),
    and which is returned; or a state dict as ``Trainer.save_checkpoint``
    writes it (whole blocks), which is returned with its blocks cut.  The
    names of ``DATA_INDEXED`` map to the port's tensors as listed
    beside it."""
    cut = batch_sharding(mesh, axis).shard
    if isinstance(trainer_or_state, dict):
        return map_state_blocks(trainer_or_state, cut, data_indexed)
    tr = trainer_or_state
    model = tr.model
    for head in _MODEL_BLOCKS:
        if head in data_indexed:
            for block in getattr(model, head).values():
                _cut_block(block, cut, [tr.optimizer])
    pe = tr._PE
    if "pe_q" in data_indexed:
        opts = [pe.optimizer] if "pe_opt_state" in data_indexed else []
        _cut_block(pe.q, cut, opts)
    if tr.optimizer is not None:
        tr._params = list(model.parameters())
    return tr


def _cut_block(block: nn.ParameterDict, cut, optimizers) -> None:
    """Replace every parameter of ``block`` by one holding ``cut`` of its
    rows; in ``optimizers`` (None entries skipped) the parameter's place
    and its moments follow."""
    for key in list(block.keys()):
        old = block[key]
        new = nn.Parameter(cut(old.detach()).clone())
        block[key] = new
        for opt in optimizers:
            if opt is None:
                continue
            for group in opt.param_groups:
                group["params"] = [new if p is old else p
                                   for p in group["params"]]
            if old in opt.state:
                opt.state[new] = _cut_state(opt.state.pop(old), cut)
