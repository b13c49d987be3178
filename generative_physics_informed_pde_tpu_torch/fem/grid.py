"""Structured triangular grids on the unit square.

The port's own copy of ``generative_physics_informed_pde_tpu/fem/grid.py``
(pure numpy; the port imports nothing of the JAX package).  Replaces the
reference's FEniCS meshes
(``df.UnitSquareMesh`` + ``refine``, reference: factories/model.py:132-134,
fawkes/utils.py:9-14).  The reference only ever uses uniformly refined
unit-square meshes with CG1 (P1) and DG0 spaces, so instead of a general mesh
library we expose a single static-geometry grid class whose connectivity is
computed once on the host (numpy) and then used to drive closed-form, fully
vectorised on-device assembly.

Conventions (matching FEniCS ``UnitSquareMesh(nx, ny)`` with the default
"right" diagonal):

* nodes: ``(nx+1) * (ny+1)`` vertices, node id ``n = iy * (nx+1) + ix``
  (row-major, bottom row first).  P1 dof == vertex.
* cells: each grid square ``(ix, iy)`` is split along the lower-left ->
  upper-right diagonal into two triangles:

  - ``t = 0`` (lower): vertices ``(ix,iy), (ix+1,iy), (ix+1,iy+1)``
  - ``t = 1`` (upper): vertices ``(ix,iy), (ix+1,iy+1), (ix,iy+1)``

  cell id ``c = (iy * nx + ix) * 2 + t``.  DG0 dof == cell.
* pixels: images use the standard image convention of the reference's
  ``DiscontinuousGalerkinPixelConverter`` (bottleneck/utils.py:69-98):
  pixel row 0 is the TOP of the domain, i.e. pixel ``(r, col)`` covers grid
  square ``(ix=col, iy=ny-1-r)``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class StructuredTriGrid:
    """Uniform right-diagonal triangulation of ``[0, lx] x [0, ly]``."""

    nx: int
    ny: int
    lx: float = 1.0
    ly: float = 1.0

    def __post_init__(self):
        if self.nx < 1 or self.ny < 1:
            raise ValueError("grid must have at least one square per axis")

    # ---------------------------------------------------------------- sizes
    @property
    def n_nodes(self) -> int:
        return (self.nx + 1) * (self.ny + 1)

    @property
    def n_cells(self) -> int:
        return 2 * self.nx * self.ny

    @property
    def n_pixels(self) -> int:
        return self.nx * self.ny

    @property
    def hx(self) -> float:
        return self.lx / self.nx

    @property
    def hy(self) -> float:
        return self.ly / self.ny

    # ----------------------------------------------------------- node data
    def node_id(self, ix, iy):
        """Vectorised (ix, iy) -> node id."""
        return np.asarray(iy) * (self.nx + 1) + np.asarray(ix)

    @cached_property
    def node_coords(self) -> np.ndarray:
        """(n_nodes, 2) float64 vertex coordinates."""
        ix, iy = np.meshgrid(np.arange(self.nx + 1), np.arange(self.ny + 1))
        x = ix.ravel() * self.hx
        y = iy.ravel() * self.hy
        return np.stack([x, y], axis=1).astype(np.float64)

    # ----------------------------------------------------------- cell data
    @cached_property
    def cells(self) -> np.ndarray:
        """(n_cells, 3) int32 vertex ids per triangle (counter-clockwise)."""
        ix, iy = np.meshgrid(np.arange(self.nx), np.arange(self.ny))
        ix = ix.ravel()
        iy = iy.ravel()
        v00 = self.node_id(ix, iy)
        v10 = self.node_id(ix + 1, iy)
        v11 = self.node_id(ix + 1, iy + 1)
        v01 = self.node_id(ix, iy + 1)
        lower = np.stack([v00, v10, v11], axis=1)
        upper = np.stack([v00, v11, v01], axis=1)
        cells = np.empty((self.n_cells, 3), dtype=np.int32)
        cells[0::2] = lower
        cells[1::2] = upper
        return cells

    @cached_property
    def cell_midpoints(self) -> np.ndarray:
        """(n_cells, 2) float64 triangle centroids (DG0 "points",
        reference: physics/RandomField.py:237-250)."""
        return self.node_coords[self.cells].mean(axis=1)

    @cached_property
    def cell_areas(self) -> np.ndarray:
        """(n_cells,) float64 triangle areas."""
        p = self.node_coords[self.cells]  # (nc, 3, 2)
        d1 = p[:, 1] - p[:, 0]
        d2 = p[:, 2] - p[:, 0]
        return 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    # ------------------------------------------------------ boundary masks
    @cached_property
    def boundary_node_masks(self) -> dict:
        """Boolean masks over node ids for the four unit-square edges
        (reference: physics/LinearEllipticFactories.py:26-40)."""
        xy = self.node_coords
        eps = 1e-12
        return {
            "left": xy[:, 0] < eps,
            "right": xy[:, 0] > self.lx - eps,
            "bottom": xy[:, 1] < eps,
            "top": xy[:, 1] > self.ly - eps,
        }

    def boundary_nodes(self, side: str) -> np.ndarray:
        return np.nonzero(self.boundary_node_masks[side])[0]

    # ------------------------------------------------------- pixel mapping
    @cached_property
    def pixel_to_cells(self) -> np.ndarray:
        """(py, px, 2) int32: the two cell ids covered by each image pixel.

        Image row 0 = top of the domain (matches the reference's
        DG0<->pixel convention, bottleneck/utils.py:69-98).
        """
        r, col = np.meshgrid(np.arange(self.ny), np.arange(self.nx), indexing="ij")
        iy = self.ny - 1 - r
        base = (iy * self.nx + col) * 2
        return np.stack([base, base + 1], axis=-1).astype(np.int32)

    # ------------------------------------------------------ refinement map
    def refined(self, num_refines: int = 1) -> "StructuredTriGrid":
        """Uniform refinement (each refine doubles nx, ny); replaces
        fawkes/utils.py:9-14 ``refine``."""
        f = 2 ** num_refines
        return StructuredTriGrid(self.nx * f, self.ny * f, self.lx, self.ly)

    def locate(self, points: np.ndarray):
        """Locate points in the grid: returns (ix, iy, fx, fy) with integer
        square indices and in-square fractional coordinates in [0, 1]."""
        pts = np.asarray(points, dtype=np.float64)
        gx = np.clip(pts[:, 0] / self.hx, 0.0, self.nx - 1e-12)
        gy = np.clip(pts[:, 1] / self.hy, 0.0, self.ny - 1e-12)
        ix = np.minimum(gx.astype(np.int64), self.nx - 1)
        iy = np.minimum(gy.astype(np.int64), self.ny - 1)
        return ix, iy, gx - ix, gy - iy

    def __repr__(self):  # pragma: no cover
        return (f"StructuredTriGrid({self.nx}x{self.ny}: {self.n_nodes} nodes,"
                f" {self.n_cells} cells)")
