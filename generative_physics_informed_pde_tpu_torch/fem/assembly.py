"""Closed-form P1 stiffness assembly on structured triangular grids.

Port of ``generative_physics_informed_pde_tpu/fem/assembly.py``: the same
element matrices, assembly tensor and 7-point stencil table, with the
stencil coefficients computed in torch.  The weak form is
``a(u, v) = sum_c alpha_c * integral_c grad(u) . grad(v)`` with ``alpha``
piecewise constant (DG0).  Three equivalent forms of the stiffness action:

1. ``assembly_tensor`` -- dense ``M[i, j, c]`` with ``K(alpha) = M @ alpha``
   (the coarse ROM grid).
2. COO triples ``(rows, cols, cell, w)`` -- the gather/scatter oracle
   (``dense_stiffness``, used by ``solve_direct``).
3. ``StencilOperator`` -- a 7-point nodal stencil whose per-node
   coefficients are static linear images of ``alpha``; the fine-grid
   matvec is the stencil apply of ``ops/stencil.py`` (``apply_coeff``,
   ``matvec`` and :func:`apply_batch_last` launch the kernel K1 on a CUDA
   tensor and run its plain version on a CPU tensor).

``coefficients_sym`` gives the symmetric 4-grid form of the stencil (the
``sym=True`` solve) and ``cell_bilinear`` the per-cell energy that the
solve's VJP needs for the conductivity gradient.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .grid import StructuredTriGrid
from ..ops.stencil import apply_stencil


def element_stiffness(grid: StructuredTriGrid) -> np.ndarray:
    """(2, 3, 3) float64: unit-conductivity P1 element stiffness matrices
    for the lower (t=0) and upper (t=1) triangle orientations."""
    Ke = np.zeros((2, 3, 3), dtype=np.float64)
    for t in range(2):
        p = grid.node_coords[grid.cells[t]]
        x, y = p[:, 0], p[:, 1]
        area = 0.5 * abs((x[1] - x[0]) * (y[2] - y[0])
                         - (x[2] - x[0]) * (y[1] - y[0]))
        b = np.array([y[1] - y[2], y[2] - y[0], y[0] - y[1]])
        c = np.array([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
        Ke[t] = (np.outer(b, b) + np.outer(c, c)) / (4.0 * area)
    return Ke


def coo_triples(grid: StructuredTriGrid):
    """COO stiffness structure: arrays ``(rows, cols, cells, w)`` such that
    ``K(alpha)[rows[e], cols[e]] += w[e] * alpha[cells[e]]``."""
    Ke = element_stiffness(grid)
    cells = grid.cells
    nc = grid.n_cells
    t = np.tile(np.array([0, 1]), nc // 2)
    a, b = np.meshgrid(np.arange(3), np.arange(3), indexing="ij")
    rows = cells[:, a.ravel()].ravel()
    cols = cells[:, b.ravel()].ravel()
    cell_ids = np.repeat(np.arange(nc), 9)
    w = Ke[t][:, a.ravel(), b.ravel()].ravel()
    return (rows.astype(np.int32), cols.astype(np.int32),
            cell_ids.astype(np.int32), w)


def assembly_tensor(grid: StructuredTriGrid, max_cells: int = 4096
                    ) -> np.ndarray:
    """Dense third-order assembly tensor ``M[i, j, c]`` with
    ``K_ij(alpha) = sum_c M[i,j,c] alpha_c`` (coarse grids only)."""
    if grid.n_cells > max_cells:
        raise ValueError(
            f"assembly_tensor is for coarse grids (n_cells={grid.n_cells} > "
            f"{max_cells}); use StencilOperator for fine grids")
    nd = grid.n_nodes
    M = np.zeros((nd, nd, grid.n_cells), dtype=np.float64)
    rows, cols, cell_ids, w = coo_triples(grid)
    np.add.at(M, (rows, cols, cell_ids), w)
    return M


def dense_stiffness(grid: StructuredTriGrid, alpha) -> np.ndarray:
    """Dense K(alpha), host numpy float64 (oracle for tests)."""
    rows, cols, cell_ids, w = coo_triples(grid)
    K = np.zeros((grid.n_nodes, grid.n_nodes), dtype=np.float64)
    np.add.at(K, (rows, cols), w * np.asarray(alpha)[cell_ids])
    return K


# Node-grid offsets (dy, dx) reachable on the right-diagonal triangulation;
# the order fixes the coefficient grids' order and the kernel's sum order.
_OFFSETS = ((0, 0), (1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (-1, -1))

# K is symmetric, so coefs[-dir][y, x] == coefs[+dir][y - dy, x - dx]: the
# diagonal and the three "positive" directions hold all of it (4 grids).
_SYM_DIRS = ((1, 0), (0, 1), (1, 1))


def _stencil_table(grid: StructuredTriGrid):
    """For each stencil offset ``o`` the list of contributions
    ``(t, dya, dxa, weight)``: the coefficient of offset ``o`` at node
    ``(jy, jx)`` receives ``weight * alpha[t, jy - dya, jx - dxa]`` (alpha
    zero-padded outside the cell grid)."""
    Ke = element_stiffness(grid)
    local = {
        0: [(0, 0), (1, 0), (1, 1)],  # lower
        1: [(0, 0), (1, 1), (0, 1)],  # upper
    }
    table = {o: [] for o in _OFFSETS}
    for t in range(2):
        for a in range(3):
            dxa, dya = local[t][a]
            for b in range(3):
                dxb, dyb = local[t][b]
                o = (dyb - dya, dxb - dxa)
                table[o].append((t, dya, dxa, float(Ke[t][a, b])))
    return table


@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Matrix-free stiffness action ``v -> K(alpha) v`` as a 7-point nodal
    stencil on the ``(ny+1, nx+1)`` node grid."""

    grid: StructuredTriGrid

    @cached_property
    def _table(self):
        return _stencil_table(self.grid)

    def alpha_to_cellgrid(self, alpha: torch.Tensor) -> torch.Tensor:
        """(..., n_cells) -> (..., ny, nx, 2) cell-grid layout."""
        g = self.grid
        return alpha.reshape(alpha.shape[:-1] + (g.ny, g.nx, 2))

    def to_nodegrid(self, v: torch.Tensor) -> torch.Tensor:
        g = self.grid
        return v.reshape(v.shape[:-1] + (g.ny + 1, g.nx + 1))

    def to_flat(self, v: torch.Tensor) -> torch.Tensor:
        return v.reshape(v.shape[:-2] + (self.grid.n_nodes,))

    def coefficients(self, alpha: torch.Tensor) -> torch.Tensor:
        """(..., n_cells) conductivities -> (..., 7, ny+1, nx+1) stencil
        coefficient grids, summed in the reference's order."""
        return self._grids(alpha, _OFFSETS)

    def coefficients_sym(self, alpha: torch.Tensor) -> torch.Tensor:
        """(..., n_cells) -> (..., 4, ny+1, nx+1): the symmetric form
        ``[diag, c_N, c_E, c_D]`` with ``c_dir[y, x] = K[(y,x), (y,x)+dir]``
        for dir in ``_SYM_DIRS``, zero where ``(y,x)+dir`` leaves the
        grid."""
        return self._grids(alpha, ((0, 0),) + _SYM_DIRS)

    def _grids(self, alpha, offsets):
        g = self.grid
        a = self.alpha_to_cellgrid(alpha)
        ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
        ny1, nx1 = g.ny + 1, g.nx + 1
        coefs = []
        for o in offsets:
            c = torch.zeros(a.shape[:-3] + (ny1, nx1), dtype=alpha.dtype,
                            device=alpha.device)
            for (t, dya, dxa, w) in self._table[o]:
                y0 = 1 - dya
                x0 = 1 - dxa
                c = c + w * ap[..., y0:y0 + ny1, x0:x0 + nx1, t]
            coefs.append(c)
        return torch.stack(coefs, dim=-3)

    def apply_coeff(self, coefs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Stencil apply, batch first: coefs (..., 7, Ny, Nx), v (..., Ny,
        Nx) -> (..., Ny, Nx), the leading dims broadcast.  One K1 launch
        over the flattened batch, in K1's batch-last layout with an
        all-ones mask (its plain version on the CPU)."""
        batch = torch.broadcast_shapes(coefs.shape[:-3], v.shape[:-2])
        Ny, Nx = v.shape[-2:]
        c = coefs.expand(batch + coefs.shape[-3:]).reshape(-1, 7, Ny, Nx)
        vb = v.expand(batch + (Ny, Nx)).reshape(-1, Ny, Nx)
        out = apply_batch_last(c.permute(1, 2, 3, 0).contiguous(),
                               vb.permute(1, 2, 0).contiguous())
        return out.permute(2, 0, 1).reshape(batch + (Ny, Nx))

    def matvec(self, alpha: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Stiffness matvec on flat dof vectors: alpha (..., n_cells),
        v (..., n_nodes) -> (..., n_nodes)."""
        return self.to_flat(self.apply_coeff(self.coefficients(alpha),
                                             self.to_nodegrid(v)))

    def diagonal(self, alpha: torch.Tensor) -> torch.Tensor:
        """diag(K(alpha)) as flat (..., n_nodes) vectors."""
        return self.to_flat(self.coefficients(alpha)[..., 0, :, :])

    def cell_bilinear(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """Per-cell ``e_c = u_loc^T Ke_c v_loc`` for (..., n_nodes) vectors:
        the gradient of ``u^T K(alpha) v`` with respect to ``alpha`` (the
        conductivity cotangent of the solve's VJP)."""
        Ke = torch.as_tensor(element_stiffness(self.grid), dtype=u.dtype,
                             device=u.device)
        cells = torch.as_tensor(self.grid.cells, device=u.device)
        nc = self.grid.n_cells
        t = torch.as_tensor(np.tile(np.array([0, 1]), nc // 2),
                            device=u.device)
        return torch.einsum("...ca,cab,...cb->...c", u[..., cells], Ke[t],
                            v[..., cells])


def apply_batch_last(coefs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked stencil apply in K1's layout: coefs (7, Ny, Nx, B) and v
    (Ny, Nx, B), both contiguous, -> (Ny, Nx, B).  K1 with an all-ones
    mask on a CUDA tensor (multiplying by 1 is exact), its plain version on
    a CPU tensor; the sum runs in the ``_OFFSETS`` order either way."""
    ones = torch.ones(v.shape[:2] + (1,), dtype=v.dtype, device=v.device)
    return apply_stencil(coefs, v, ones)
