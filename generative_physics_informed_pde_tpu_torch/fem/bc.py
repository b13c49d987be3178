"""Boundary-condition families and ensembles.

Port of ``generative_physics_informed_pde_tpu/fem/bc.py``.  Both families
share one geometry: Dirichlet on the left/right edges of the unit square,
zero Neumann on top/bottom, zero source.

* ``'ND'``  -- constant Dirichlet: u=0 on the left, u=1 on the right.
* ``'NDP'`` -- per-sample random linear Dirichlet profiles
  ``u_left(y) = u0 (1-y) + u1 y``, ``u_right(y) = u2 (1-y) + u3 y`` with
  ``u0..u3 ~ U(-1/2, 1/2)``; ``theta = (u0, u1, u2, u3)`` is the encoding.

The thetas come from a numpy ``Generator`` exactly as in the JAX package,
so the same seed gives the same boundary conditions bit for bit.  The
bookkeeping is host numpy; ``DirichletProfile.scatter_full`` and
``restrict_free`` also take and give tensors.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict

import numpy as np
import torch

from .grid import StructuredTriGrid

FAMILIES = ("ND", "NDP")

THETA_DIM = 4  # (u0, u1, u2, u3)


def sample_theta(rng: np.random.Generator, family: str, n: int) -> np.ndarray:
    """Sample boundary encodings, (n, 4) float64 ('ND' is fixed at
    (0, 0, 1, 1))."""
    family = family.upper()
    if family == "ND":
        return np.tile(np.array([0.0, 0.0, 1.0, 1.0]), (n, 1))
    if family == "NDP":
        return rng.uniform(-0.5, 0.5, size=(n, THETA_DIM))
    raise NotImplementedError(family)


@dataclasses.dataclass(frozen=True)
class DirichletProfile:
    """Constrained dof bookkeeping for one function space (grid)."""

    grid: StructuredTriGrid

    @cached_property
    def constrained_dofs(self) -> np.ndarray:
        """Sorted left+right edge node ids."""
        left = self.grid.boundary_nodes("left")
        right = self.grid.boundary_nodes("right")
        return np.unique(np.concatenate([left, right]))

    @cached_property
    def free_dofs(self) -> np.ndarray:
        mask = np.ones(self.grid.n_nodes, dtype=bool)
        mask[self.constrained_dofs] = False
        return np.nonzero(mask)[0]

    @cached_property
    def free_mask(self) -> np.ndarray:
        """(n_nodes,) float64 1/0 mask of free dofs."""
        m = np.ones(self.grid.n_nodes, dtype=np.float64)
        m[self.constrained_dofs] = 0.0
        return m

    @cached_property
    def n_constrained(self) -> int:
        return self.constrained_dofs.size

    @cached_property
    def n_free(self) -> int:
        return self.free_dofs.size

    @cached_property
    def _profile_basis(self) -> np.ndarray:
        """(n_constrained, 4): values at constrained dofs are
        ``basis @ theta``."""
        xy = self.grid.node_coords[self.constrained_dofs]
        y = xy[:, 1] / self.grid.ly
        on_left = np.asarray(
            self.grid.boundary_node_masks["left"])[self.constrained_dofs
                                                   ].astype(np.float64)
        on_right = 1.0 - on_left
        return np.stack(
            [on_left * (1 - y), on_left * y, on_right * (1 - y), on_right * y],
            axis=1)

    def constrained_values(self, theta) -> np.ndarray:
        """theta (..., 4) -> values at constrained dofs (..., n_constrained),
        float64."""
        return np.asarray(theta, dtype=np.float64) @ self._profile_basis.T

    def scatter_full(self, values, free_values=None) -> torch.Tensor:
        """Full dof vectors (..., n_nodes): ``values`` at the constrained
        dofs, ``free_values`` (or zero) at the free ones; the leading batch
        dims of the two broadcast, the dtype is their common one and the
        device that of ``values``."""
        values = torch.as_tensor(values)
        dt = values.dtype
        batch = values.shape[:-1]
        if free_values is not None:
            free_values = torch.as_tensor(free_values, device=values.device)
            dt = torch.promote_types(dt, free_values.dtype)
            batch = torch.broadcast_shapes(batch, free_values.shape[:-1])
        full = torch.zeros(batch + (self.grid.n_nodes,), dtype=dt,
                           device=values.device)
        full[..., torch.as_tensor(self.constrained_dofs,
                                  device=values.device)] = values.to(dt)
        if free_values is not None:
            full[..., torch.as_tensor(self.free_dofs, device=values.device)] \
                = free_values.to(dt)
        return full

    def restrict_free(self, full: torch.Tensor) -> torch.Tensor:
        return full[..., torch.as_tensor(self.free_dofs, device=full.device)]


class BoundaryConditionEnsemble:
    """Batched per-sample boundary conditions over named function spaces
    ('fom'/'rom'): constrained values and the ROM force matrix with the
    Dirichlet values applied."""

    def __init__(self, family: str, thetas: np.ndarray):
        family = family.upper()
        if family not in FAMILIES:
            raise NotImplementedError(family)
        # copy: external mutation would desynchronize the cached forces
        thetas = np.array(thetas, dtype=np.float64, copy=True)
        if thetas.ndim != 2 or thetas.shape[1] != THETA_DIM:
            raise ValueError(
                f"thetas must be (N, {THETA_DIM}), got {thetas.shape}")
        self.family = family
        self.thetas = thetas
        self._profiles: Dict[str, DirichletProfile] = {}
        self._F: Dict[str, np.ndarray] = {}

    @classmethod
    def from_factory(cls, family: str, n: int, rng: np.random.Generator):
        """Sample N boundary conditions from an explicit numpy Generator."""
        return cls(family, sample_theta(rng, family, n))

    @classmethod
    def from_encoding(cls, family: str, thetas):
        """Rebuild an ensemble from its (N, 4) encodings."""
        return cls(family, thetas)

    def encode(self) -> np.ndarray:
        """The (N, 4) encodings, a copy."""
        return self.thetas.copy()

    def register_function_space(self, identifier: str,
                                grid: StructuredTriGrid):
        identifier = identifier.lower()
        if identifier not in self._profiles:
            self._profiles[identifier] = DirichletProfile(grid)

    def check_if_registered(self, identifier: str) -> bool:
        return identifier.lower() in self._profiles

    def profile(self, identifier: str) -> DirichletProfile:
        return self._profiles[identifier.lower()]

    def __len__(self):
        return self.thetas.shape[0]

    def __getitem__(self, idx):
        """Sub-ensemble of the selected rows, sharing the registered
        function spaces."""
        sub = BoundaryConditionEnsemble(self.family,
                                        np.atleast_2d(self.thetas[idx]))
        sub._profiles = self._profiles
        return sub

    def constrained_dofs(self, identifier: str) -> np.ndarray:
        return self.profile(identifier).constrained_dofs

    def free_dofs(self, identifier: str) -> np.ndarray:
        return self.profile(identifier).free_dofs

    def constrained_values(self, identifier: str) -> np.ndarray:
        """(N, n_constrained) float64, host numpy."""
        return self.profile(identifier).constrained_values(self.thetas)

    def full_f_with_applied_bc(self, identifier: str) -> np.ndarray:
        """(N, ndof) read-only: zero force with the Dirichlet values
        inserted at the constrained dofs (the ROM's F)."""
        identifier = identifier.lower()
        if identifier not in self._F:
            p = self.profile(identifier)
            n_elem = len(self) * p.grid.n_nodes
            if n_elem > 2 ** 28:
                raise ValueError(
                    f"full_f_with_applied_bc('{identifier}') would "
                    f"materialise {len(self)} x {p.grid.n_nodes} float64; "
                    "this matrix is only needed for the ROM space")
            F = np.zeros((len(self), p.grid.n_nodes), dtype=np.float64)
            F[:, p.constrained_dofs] = self.constrained_values(identifier)
            F.setflags(write=False)
            self._F[identifier] = F
        return self._F[identifier]

    # the reference's upper-case name
    FULL_F_WITH_APPLIED_BC = full_f_with_applied_bc
