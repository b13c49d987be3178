"""Point probes and quantities of interest (QOI).

The port's own copy of ``generative_physics_informed_pde_tpu/fem/probe.py``.
Re-implementation of ``Probe`` (reference: fawkes/Probe.py:11-177) and
``QOI`` / ``SquareSubdomain`` (reference: bottleneck/flux.py:162-246): both
reduce to evaluating P1 basis functions at points or integrating over cell
subsets -- closed-form linear functionals on the structured grid (host
numpy float64), applied as one matrix product on the solutions' device
(batched over solution ensembles).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

import numpy as np
import torch

from .grid import StructuredTriGrid
from .interpolation import p1_interpolation_matrix


@dataclasses.dataclass(frozen=True, eq=False)
class Probe:
    """Evaluate nodal (CG1) fields at fixed points through one static
    interpolation matrix (identity equality: the points are an
    ndarray)."""

    grid: StructuredTriGrid
    points: np.ndarray  # (n_points, 2)

    @cached_property
    def matrix(self) -> np.ndarray:
        return p1_interpolation_matrix(self.grid, self.points)

    def __call__(self, u: torch.Tensor) -> torch.Tensor:
        """u (..., n_nodes) -> (..., n_points), on u's device."""
        M = torch.as_tensor(self.matrix, dtype=u.dtype, device=u.device)
        return u @ M.T


@dataclasses.dataclass(frozen=True)
class QOI:
    """Point or square-subdomain-integral functional of the solution
    (reference: bottleneck/flux.py:162-246).

    * ``L is None``: point evaluation at (mx, my),
    * else: integral of u over the square |x-mx|<=L, |y-my|<=L (cells
      selected by midpoint, matching the reference's SubDomain marking).
    """

    grid: StructuredTriGrid
    mx: float = 0.5
    my: float = 0.5
    L: Optional[float] = None

    @cached_property
    def functional(self) -> np.ndarray:
        """(n_nodes,) float64 weights: qoi(u) = functional . u."""
        if self.L is None:
            return p1_interpolation_matrix(
                self.grid, np.array([[self.mx, self.my]])).ravel()
        mids = self.grid.cell_midpoints
        inside = np.nonzero((np.abs(mids[:, 0] - self.mx) <= self.L)
                            & (np.abs(mids[:, 1] - self.my) <= self.L))[0]
        # integral of u over the selected cells: each P1 vertex contributes
        # area/3 (the derivative of the integral wrt its nodal value);
        # np.add.at adds in the cells' order, as a loop over them would
        w = np.zeros(self.grid.n_nodes)
        np.add.at(w, self.grid.cells[inside].ravel(),
                  np.repeat(self.grid.cell_areas[inside] / 3.0, 3))
        return w

    def extract(self, Y: torch.Tensor, bc_values=None,
                profile=None) -> torch.Tensor:
        """Apply the functional to solutions, on Y's device.

        Y: (..., n_nodes) full vectors, or (..., n_free) restricted ones if
        ``profile`` (a DirichletProfile) and per-sample ``bc_values`` are
        given (reference _complete, flux.py:201-210)."""
        if profile is not None:
            Y = profile.scatter_full(bc_values, free_values=Y)
        f = torch.as_tensor(self.functional, dtype=Y.dtype, device=Y.device)
        return Y @ f
