"""Dataset management: raw random fields -> assembled training arrays,
named partitions, lazy dataset views.

Port of ``DataLoader`` / ``DataSet`` from
``generative_physics_informed_pde_tpu/data/loader.py``: the fields stay
host numpy float64; labels come from the port's batched solve in dispatches
of ``label_batch`` fields (the tail padded, as the reference pads it); the
partition bookkeeping keeps the reference's permutation-compatible
semantics, and a ``DataSet`` view hands out tensors of its dtype on its
device (or a random minibatch of them, the rows picked by a numpy
generator as the JAX package picks them).  ``from_sampler`` draws a pool from the port's random field;
``save`` / ``from_file`` keep the fields and their hash in the JAX
package's file format (``np.savez`` of ``X`` and ``hash``), so a file moves
between the two packages.  Left out: the reference's retry loop around a
label dispatch, a guard against restarts of a remote TPU worker.
"""

from __future__ import annotations

import hashlib
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..fem.bc import BoundaryConditionEnsemble
from ..fem.pixels import PixelConverter
from ..utils.device import resolve_device
from ..utils.time import span


def draw_fields(sampler, N: int, generator: torch.Generator,
                dtype=torch.float64, device="cuda") -> np.ndarray:
    """``N`` fields of ``sampler`` drawn with ``generator`` in ``dtype`` on
    ``device``, in batches of its ``max_sample_batch`` (a memory bound),
    returned on the host."""
    device = resolve_device(device)
    # one chunk size, the sampler's memory bound: the JAX package's fixed
    # 128/1024 chunks bound its compiled shapes on the TPU
    step = max(1, sampler.max_sample_batch)
    return np.concatenate([
        sampler.sample(generator, batch_size=min(step, N - i), dtype=dtype,
                       device=device).cpu().numpy()
        for i in range(0, N, step)])


class DataLoader:
    """Owns the raw field array X (N, py, px) and its assembled products."""

    VALID_KEYS = ("X", "X_DG", "Y", "F_ROM_BC", "BCE")

    def __init__(self, X: np.ndarray, X_DG=None, Y=None, BCE=None,
                 F_ROM_BC=None, hash=None):
        X = np.asarray(X, dtype=np.float64)
        if X.ndim != 3:
            raise ValueError("X must be (N, py, px)")
        if BCE is not None and len(BCE) != X.shape[0]:
            raise ValueError(
                f"BCE has {len(BCE)} boundary conditions for "
                f"{X.shape[0]} fields")
        self._X = X
        self._X_DG = X_DG
        self._Y = Y
        self._BCE = BCE
        self._F_ROM_BC = F_ROM_BC
        self._permutation: Dict[str, np.ndarray] = {}
        self._assigned_chunks: Dict[str, dict] = {}
        self._state_indicator: Dict[str, int] = {}
        self._dependent_datasets = []
        self._hash = hash
        self._lock_physics_assembly = False
        # of the last assemble: PCG iterations per dispatch, dispatch size
        self.label_iterations = []
        self.label_batch = None

    @classmethod
    def from_sampler(cls, sampler, N: int, key=None, dtype=torch.float64,
                     device="cuda") -> "DataLoader":
        """``N`` fields of ``sampler`` (a ``GaussianRandomField``) drawn in
        ``dtype`` on ``device``, in batches of its ``max_sample_batch``,
        from a ``torch.Generator`` on ``device`` seeded by ``key`` (default
        0); the fields are kept on the host in float64.  As the JAX
        package's, the draw runs on the accelerator when there is one (a
        host generator draws 10,240 fields of 256^2 in minutes): the same
        key gives the same pool on every run on one device type, but the
        card's stream is not the CPU's, and neither is the JAX package's."""
        device = resolve_device(device)
        generator = torch.Generator(device).manual_seed(
            0 if key is None else int(key))
        return cls(draw_fields(sampler, N, generator, dtype, device))

    # --------------------------------------------------------------- io
    def save(self, path: str):
        """Write the raw fields and their hash to ``path`` (``.npz``)."""
        if not path.endswith(".npz"):
            # np.savez appends '.npz' to any other name, so save() would
            # write to a different file than from_file() later reads
            raise ValueError(f"path must end with .npz, got {path!r}")
        np.savez(path, X=self._X, hash=np.bytes_(self.hash.encode()))

    @classmethod
    def from_file(cls, path: str) -> "DataLoader":
        with np.load(path, allow_pickle=False) as state:
            return cls(X=state["X"], hash=bytes(state["hash"]).decode())

    # ------------------------------------------------------------ basic
    def lock_physics_assembly(self):
        """Mark as unlabeled-only."""
        self._lock_physics_assembly = True

    @property
    def hash(self) -> str:
        if self._hash is None:
            self._hash = hashlib.sha256(
                np.ascontiguousarray(self._X)).hexdigest()
        return self._hash

    @property
    def N(self) -> int:
        return self._X.shape[0]

    def __len__(self):
        return self.N

    def register_dataset(self, dataset):
        # weak refs: superseded views must not be pinned by the loader
        self._dependent_datasets.append(weakref.ref(dataset))

    def _live_datasets(self):
        out = [r() for r in self._dependent_datasets]
        self._dependent_datasets = [r for r, d in
                                    zip(self._dependent_datasets, out)
                                    if d is not None]
        return [d for d in out if d is not None]

    # --------------------------------------------------------- assembly
    def assemble_BCE(self, physics, rng: Optional[np.random.Generator] = None):
        """Sample one boundary condition per field; without ``rng`` the
        draw is seeded from the loader's content hash, so the same fields
        give the same boundary conditions."""
        if rng is None:
            rng = np.random.default_rng(int(self.hash[:16], 16))
        family = physics["fom"].physics_id
        self._BCE = BoundaryConditionEnsemble.from_factory(family, self.N, rng)
        self._BCE.register_function_space("rom", physics["rom"].grid)
        self._BCE.register_function_space("fom", physics["fom"].grid)

    def assemble(self, physics, BCE: Optional[BoundaryConditionEnsemble] = None,
                 rng: Optional[np.random.Generator] = None,
                 label_batch: int = 256, rows=None):
        """Assemble X_DG, the labels Y (batched solves on the physics'
        device, in float64 as the fields are) and F_ROM_BC.

        ``rows``: optional row indices, boolean mask or slice to solve
        labels for; the other rows are left NaN, so a row solved by nobody
        surfaces as a non-finite loss, never as a silent wrong label.

        Spans (``utils.time.span``): ``loader.assemble`` around it all,
        ``loader.bce`` (content hash and BCE draw), ``loader.prepare``
        (``X_DG`` and the label array, then per dispatch ``exp``, the tail
        padding and the copy to the device), ``loader.readback`` (per
        dispatch, the labels to the host) and ``loader.rom_bc``."""
        if self._lock_physics_assembly:
            raise RuntimeError("physics assembly locked for this loader")
        with span("loader.assemble"):
            self._assemble(physics, BCE, rng, label_batch, rows)

    def _assemble(self, physics, BCE, rng, label_batch, rows):
        with span("loader.bce"):
            if self._BCE is None and BCE is not None:
                if not (BCE.check_if_registered("fom")
                        and BCE.check_if_registered("rom")):
                    raise ValueError("BCE must have the 'fom' and 'rom' "
                                     "function spaces registered")
                if len(BCE) != self.N:
                    raise ValueError(
                        f"BCE has {len(BCE)} boundary conditions for "
                        f"{self.N} fields -- a mismatched ensemble would "
                        "silently mislabel the dataset")
                self._BCE = BCE
            elif self._BCE is None:
                self.assemble_BCE(physics, rng)
        fom = physics["fom"]
        with span("loader.prepare"):
            cell_to_pixel = PixelConverter(fom.grid)._cell_to_pixel
            self._X_DG = self._X.reshape(self.N, -1)[:, cell_to_pixel]
            vals = self._BCE.constrained_values("fom")
            if rows is None:
                row_idx = np.arange(self.N)
                Y = np.zeros((self.N, fom.dim_out), dtype=np.float64)
            else:
                if isinstance(rows, slice):
                    row_idx = np.arange(self.N)[rows]
                else:
                    r = np.asarray(rows)
                    # a boolean mask is a mask, not the indices {0, 1}
                    row_idx = np.flatnonzero(r) if r.dtype == np.bool_ \
                        else r.astype(np.int64)
                Y = np.full((self.N, fom.dim_out), np.nan, dtype=np.float64)
        label_batch = max(8, min(label_batch, 2 ** 22 // fom.grid.n_cells))
        self.label_iterations, self.label_batch = [], label_batch
        for k in range(-(-row_idx.size // label_batch)):
            sl = row_idx[k * label_batch: (k + 1) * label_batch]
            with span("loader.prepare"):
                a = np.exp(self._X_DG[sl])
                v = vals[sl]
                pad = label_batch - a.shape[0]
                if pad:  # pad the tail: every dispatch has one shape
                    a = np.concatenate([a, np.ones((pad,) + a.shape[1:])])
                    v = np.concatenate([v, np.zeros((pad,) + v.shape[1:])])
                a = torch.as_tensor(a, device=fom.device)
                v = torch.as_tensor(v, device=fom.device)
            # no retry loop: the reference's guarded tunnelled TPU workers
            out = fom.solve_batched(a, v)
            with span("loader.readback"):
                Y[sl] = out[: sl.size].cpu().numpy()
            self.label_iterations.append(fom.last_iterations)
        self._Y = Y
        with span("loader.rom_bc"):
            self._F_ROM_BC = self._BCE.full_f_with_applied_bc("rom")
            # new labels: dependent views must drop their cached tensors
            for ds in self._live_datasets():
                ds.trigger_update()

    # --------------------------------------------------------- accessors
    @property
    def X(self):
        return self._X

    def _need(self, attr, name):
        if attr is None:
            raise RuntimeError(f"{name}: assembly has not been called")
        return attr

    @property
    def X_DG(self):
        return self._need(self._X_DG, "X_DG")

    @property
    def Y(self):
        return self._need(self._Y, "Y")

    @property
    def F_ROM_BC(self):
        return self._need(self._F_ROM_BC, "F_ROM_BC")

    @property
    def BCE(self):
        return self._need(self._BCE, "BCE")

    # -------------------------------------------------------- partitions
    def reset_partition(self, identifier: Optional[str] = None):
        """Drop the partition ``identifier``, or every partition."""
        if identifier is not None:
            del self._permutation[identifier]
            del self._assigned_chunks[identifier]
            del self._state_indicator[identifier]
        else:
            self._permutation = {}
            self._assigned_chunks = {}
            self._state_indicator = {}
        for ds in self._live_datasets():
            ds.trigger_update()

    def ascending_partition(self, chunks, identifier="default",
                            ForceOverwrite=False):
        return self.randomized_partition(
            chunks, identifier=identifier, ForceOverwrite=ForceOverwrite,
            permutation=np.arange(self.N))

    def randomized_partition(self, chunks: dict, identifier: str = "default",
                             *, ForceOverwrite: bool = False,
                             permutation=None,
                             rng: Optional[np.random.Generator] = None):
        """Named disjoint chunks over a permutation."""
        if identifier in self._permutation and not ForceOverwrite:
            raise RuntimeError(f"partition '{identifier}' exists")
        if not chunks:
            raise ValueError("empty chunks")
        if sum(chunks.values()) > self.N:
            raise ValueError("partition larger than dataset")
        if permutation is None:
            rng = rng or np.random.default_rng()
            permutation = rng.permutation(self.N)
        permutation = np.asarray(permutation, dtype=np.int64)
        if permutation.shape != (self.N,) or \
                len(np.unique(permutation)) != self.N or \
                permutation.min() < 0 or permutation.max() >= self.N:
            raise ValueError(
                f"permutation must be a permutation of range({self.N})")
        self._permutation[identifier] = permutation
        self._assigned_chunks[identifier] = {}
        ptr = 0
        for label, size in chunks.items():
            self._assigned_chunks[identifier][label] = [
                np.arange(ptr, ptr + size, dtype=np.int64)]
            ptr += size
        self._state_indicator[identifier] = ptr
        self._check_chunks(identifier)

    def _check_chunks(self, identifier):
        ids = np.concatenate([np.concatenate(sub) for sub in
                              self._assigned_chunks[identifier].values()])
        unique, counts = np.unique(ids, return_counts=True)
        assert np.all(counts == 1)
        assert unique.min() >= 0 and unique.max() < self.N

    def grow_partition(self, chunks_growth: dict, identifier="default",
                       SpecifyIncremental: bool = True):
        """Extend chunks from the unassigned samples."""
        if identifier not in self._assigned_chunks:
            raise ValueError(f"unknown identifier {identifier}")
        for key in chunks_growth:
            if key not in self._assigned_chunks[identifier]:
                raise ValueError(f"unknown chunk label {key}")
        if not chunks_growth:
            raise ValueError("empty growth dict")
        chunks_growth = dict(chunks_growth)
        if not SpecifyIncremental:
            for label in chunks_growth:
                used = sum(a.size for a in
                           self._assigned_chunks[identifier][label])
                if used >= chunks_growth[label]:
                    raise ValueError
                chunks_growth[label] -= used
        available = self.N - self._state_indicator[identifier]
        if sum(chunks_growth.values()) > available:
            raise ValueError("not enough unassigned samples")
        ptr = self._state_indicator[identifier]
        for label, size in chunks_growth.items():
            self._assigned_chunks[identifier][label].append(
                np.arange(ptr, ptr + size, dtype=np.int64))
            ptr += size
        self._state_indicator[identifier] = ptr
        self._check_chunks(identifier)
        for ds in self._live_datasets():
            ds.trigger_update()

    def construct_dataset_dictionary(self, *, identifier=None, dtype,
                                     device="cuda"):
        """DataSet views per chunk, handing out ``dtype`` tensors on
        ``device``."""
        if identifier is None:
            if not self._permutation:
                raise RuntimeError("no partitions defined")
            return {ident: self.construct_dataset_dictionary(
                        identifier=ident, dtype=dtype, device=device)
                    for ident in self._permutation}
        if identifier not in self._permutation:
            raise KeyError(identifier)
        return {label: DataSet(self, label=label, identifier=identifier,
                               dtype=dtype, device=device)
                for label in self._assigned_chunks[identifier]}

    def __repr__(self):  # pragma: no cover
        return (f"DataLoader with {self.N} random field realizations "
                f"({self._X.shape[1]},{self._X.shape[2]}) "
                f"[Assembled = {self._X_DG is not None}]")


class DataSet:
    """Lazy view over one partition chunk, caching its tensors."""

    def __init__(self, dataloader: DataLoader, label: str,
                 identifier: str = "default", *, dtype, device="cuda"):
        self._dataloader = dataloader
        self.identifier = identifier
        self.label = label
        dataloader.register_dataset(self)
        self._cached_indices = None
        self._cache: dict = {}
        self._dtype = dtype
        self._device = resolve_device(device)
        self._N_target: Optional[int] = None

    @property
    def indices(self) -> np.ndarray:
        if self._cached_indices is None:
            subset = np.concatenate(
                self._dataloader._assigned_chunks[self.identifier][self.label])
            self._cached_indices = \
                self._dataloader._permutation[self.identifier][subset]
        return self._cached_indices

    def __len__(self):
        return len(self.indices) if self._N_target is None else self._N_target

    @property
    def N(self) -> int:
        return len(self)

    @property
    def N_max(self) -> int:
        return len(self.indices)

    def restrict(self, N_target: int):
        """Use only the first N_target samples."""
        if N_target > self.N_max or N_target < 0:
            raise ValueError(f"N_target must be in [0, {self.N_max}], "
                             f"got {N_target}")
        if N_target == self._N_target:
            return
        self._N_target = None if N_target == self.N_max else N_target
        self.trigger_update()

    def grow_in_size(self, N: int, incremental: bool = False):
        # non-incremental growth counts from the restricted length, as the
        # reference does
        n_add = N if incremental else N - self.N
        if n_add <= 0:
            raise ValueError
        self._dataloader.grow_partition({self.label: n_add},
                                        identifier=self.identifier)
        self.trigger_update()

    def trigger_update(self):
        self._cached_indices = None
        self._cache = {}

    def get(self, key: str, random_subset: Optional[int] = None,
            rng: Optional[np.random.Generator] = None):
        """The chunk's rows of ``key`` as a tensor on the view's device
        (X, Y, F_ROM_BC in the view's dtype; BCE as a sub-ensemble).  With
        ``random_subset`` a random minibatch of that many rows: the first
        rows of a permutation drawn from the numpy ``rng``, so one seed
        picks the same rows as the JAX package's ``get``."""
        val = self._cached(key)
        if random_subset is None or val is None:
            return val
        rng = rng or np.random.default_rng()
        idx = rng.permutation(self.N)[:random_subset]
        if key == "BCE":
            return val[list(idx)]
        return val[torch.as_tensor(idx, device=val.device)]

    def _cached(self, key: str):
        if key not in DataLoader.VALID_KEYS:
            raise ValueError(key)
        if key not in self._cache:
            if self.N == 0:
                self._cache[key] = None
            else:
                Q = getattr(self._dataloader, key)
                if key == "BCE":
                    self._cache[key] = Q[list(self.indices[: self.N])]
                else:
                    arr = np.asarray(Q)[self.indices]
                    if self._N_target is not None:
                        arr = arr[: self._N_target]
                    dtype = self._dtype if key in ("X", "Y", "F_ROM_BC") \
                        else None
                    self._cache[key] = torch.as_tensor(
                        arr, dtype=dtype, device=self._device)
        return self._cache[key]

    def __repr__(self):  # pragma: no cover
        return (f"Virtual dataset with {self.N} datapoints | {self.label} |"
                f" {self.identifier}")
