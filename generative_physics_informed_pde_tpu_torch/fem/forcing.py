"""Force-vector assembly: volumetric sources and Neumann boundary fluxes.

Port of ``generative_physics_informed_pde_tpu/fem/forcing.py``.  Both
problem families of the reference use a zero source, so these helpers pose
richer problems for ``LinearEllipticPhysics.solve_full``'s ``f_full``:

* ``volume_force``: ``f_i = integral f phi_i dx`` for a piecewise-constant
  (DG0) source -- each P1 vertex of a cell receives ``area/3 * f_c``;
* ``neumann_force``: ``f_i = integral g phi_i ds`` over one named boundary
  side with a piecewise-constant edge flux ``g`` -- each edge endpoint
  receives ``len/2 * g_e``.

The scatters are ``index_add_`` on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import StructuredTriGrid


def volume_force(grid: StructuredTriGrid,
                 f_cells: torch.Tensor) -> torch.Tensor:
    """(..., n_cells) DG0 source -> (..., n_nodes) load vector."""
    dev = f_cells.device
    cells = torch.as_tensor(grid.cells.astype(np.int64), device=dev)
    areas = torch.as_tensor(grid.cell_areas, dtype=f_cells.dtype, device=dev)
    contrib = (areas / 3.0) * f_cells                     # (..., nc)
    out = torch.zeros(f_cells.shape[:-1] + (grid.n_nodes,),
                      dtype=contrib.dtype, device=dev)
    for a in range(3):
        out.index_add_(-1, cells[:, a], contrib)
    return out


_SIDE_EDGES = {}


def _side_edges(grid: StructuredTriGrid, side: str):
    """(n_edges, 2) node-id pairs and the edge length along one side."""
    # hx / hy in the key: same-resolution grids over different physical
    # domains must not share cached edge lengths
    key = (grid.nx, grid.ny, float(grid.hx), float(grid.hy), side)
    if key not in _SIDE_EDGES:
        nodes = grid.boundary_nodes(side)
        coords = grid.node_coords[nodes]
        order = np.argsort(coords[:, 1] if side in ("left", "right")
                           else coords[:, 0])
        nodes = nodes[order]
        pairs = np.stack([nodes[:-1], nodes[1:]], axis=1)
        length = (grid.hy if side in ("left", "right") else grid.hx)
        _SIDE_EDGES[key] = (pairs.astype(np.int64), length)
    return _SIDE_EDGES[key]


def neumann_force(grid: StructuredTriGrid, side: str,
                  g_edges: torch.Tensor) -> torch.Tensor:
    """(..., n_side_edges) edge fluxes -> (..., n_nodes) load vector."""
    pairs, length = _side_edges(grid, side)
    pairs = torch.as_tensor(pairs, device=g_edges.device)
    contrib = 0.5 * length * g_edges
    out = torch.zeros(g_edges.shape[:-1] + (grid.n_nodes,),
                      dtype=contrib.dtype, device=g_edges.device)
    out.index_add_(-1, pairs[:, 0], contrib)
    out.index_add_(-1, pairs[:, 1], contrib)
    return out
