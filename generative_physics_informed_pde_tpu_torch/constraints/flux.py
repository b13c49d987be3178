"""Flux-continuity constraints across coarse-cell boundaries.

Port of ``generative_physics_informed_pde_tpu/constraints/flux.py``, with
its own copy of the host-side assembly.  On the nested structured
triangulation, the flux of ``alpha grad(u)`` out of a coarse cell Q has a
closed form: each fine edge on the boundary of Q contributes
``alpha_c * (grad phi_a|_c . n) * |e|`` for the three P1 dofs of the fine
cell c on the INSIDE of Q, with n the outward normal of Q.

Conventions of the JAX package:

* interior coarse facets: one-sided evaluation from the inside of Q;
* coarse facets on the Dirichlet (left/right) domain boundary: exterior
  integral from the inside;
* coarse facets on the top/bottom domain boundary: skipped (zero Neumann;
  the true flux vanishes there).

The constraint is linear in both alpha (per fine cell) and u, so the whole
operator is a static sparse 3-tensor assembled once on the host:
``Gamma(alpha)[q, i] = sum_e w_e * alpha[c_e]`` over the entries with
``(q_e, i_e)``.  The JAX package evaluates it with one scatter-add; here
the entries are grouped by ``(q, i)`` on the host and each group is summed
in a fixed order, so no atomic adds are needed and ``Gamma`` is the same
from run to run on a card.

The reduced right-hand side is the corrected one of the JAX package:
``alpha_rhs = -Gamma[:, constrained] @ y_c``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from ..fem.grid import StructuredTriGrid


def _cell_gradients(grid: StructuredTriGrid, cell_id: int) -> np.ndarray:
    """(3, 2) constant P1 basis gradients on one triangle."""
    p = grid.node_coords[grid.cells[cell_id]]
    x, y = p[:, 0], p[:, 1]
    det = (x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0])
    b = np.array([y[1] - y[2], y[2] - y[0], y[0] - y[1]]) / det
    c = np.array([x[2] - x[1], x[0] - x[2], x[1] - x[0]]) / det
    return np.stack([b, c], axis=1)


def _locate_cell(grid: StructuredTriGrid, point: np.ndarray) -> int:
    """Cell id containing a (strictly interior) point."""
    ix, iy, fx, fy = grid.locate(point[None, :])
    t = 0 if fx[0] >= fy[0] else 1
    return int((iy[0] * grid.nx + ix[0]) * 2 + t)


@dataclasses.dataclass(frozen=True)
class FluxConstraintOperator:
    """Static flux-constraint assembly data for a (coarse, fine) grid pair."""

    coarse: StructuredTriGrid
    fine: StructuredTriGrid

    @property
    def n_constraints(self) -> int:
        return self.coarse.n_cells

    @cached_property
    def _entries(self):
        """COO entries (q, i, c, w): constraint q, fine dof i, fine cell c,
        weight w."""
        fine, coarse = self.fine, self.coarse
        refine = fine.nx // coarse.nx
        if (refine * coarse.nx != fine.nx
                or fine.ny // coarse.ny * coarse.ny != fine.ny
                or fine.ny // coarse.ny != refine):
            # unequal x/y refinement would split coarse edges into the
            # wrong number of sub-edges and put coarse diagonals off the
            # fine edge lattice -- silently wrong constraint weights
            raise ValueError(
                f"fine grid ({fine.nx}x{fine.ny}) must refine coarse "
                f"({coarse.nx}x{coarse.ny}) by the SAME integer factor "
                "on both axes")
        eps = 1e-9

        qs, is_, cs, ws = [], [], [], []
        for q in range(coarse.n_cells):
            verts = coarse.node_coords[coarse.cells[q]]
            for a in range(3):
                p0, p1 = verts[a], verts[(a + 1) % 3]
                edge = p1 - p0
                length = np.linalg.norm(edge)
                tangent = edge / length
                # outward normal: rotate tangent by -90deg (cells are CCW)
                normal = np.array([tangent[1], -tangent[0]])
                on_bottom = (abs(p0[1]) < eps and abs(p1[1]) < eps)
                on_top = (abs(p0[1] - coarse.ly) < eps
                          and abs(p1[1] - coarse.ly) < eps)
                if on_bottom or on_top:
                    continue
                sub_len = length / refine
                for s in range(refine):
                    mid = p0 + (s + 0.5) * (edge / refine)
                    c = _locate_cell(fine, mid - eps * 10 * normal)
                    w = _cell_gradients(fine, c) @ normal * sub_len  # (3,)
                    for local, dof in enumerate(fine.cells[c]):
                        qs.append(q)
                        is_.append(int(dof))
                        cs.append(c)
                        ws.append(float(w[local]))
        return (np.asarray(qs, dtype=np.int32), np.asarray(is_, dtype=np.int32),
                np.asarray(cs, dtype=np.int32), np.asarray(ws, dtype=np.float64))

    @cached_property
    def _groups(self):
        """The entries grouped by ``(q, i)``: (flat index q * n_nodes + i
        of each group (G,), cells (G, K), weights (G, K)), groups shorter
        than K padded with weight 0 on cell 0."""
        q, i, c, w = self._entries
        flat = q.astype(np.int64) * self.fine.n_nodes + i
        order = np.argsort(flat, kind="stable")
        keys, start, count = np.unique(flat[order], return_index=True,
                                       return_counts=True)
        K = int(count.max())
        cells = np.zeros((keys.size, K), dtype=np.int64)
        weights = np.zeros((keys.size, K), dtype=np.float64)
        for k in range(K):
            has = count > k
            sel = order[start[has] + k]
            cells[has, k] = c[sel]
            weights[has, k] = w[sel]
        return keys, cells, weights

    def gamma_full(self, alpha: torch.Tensor) -> torch.Tensor:
        """Full constraint matrices (..., n_constraints, n_fine_nodes) for
        conductivity fields alpha (..., n_fine_cells)."""
        keys, cells, weights = self._groups
        dev = alpha.device
        w = torch.as_tensor(weights, dtype=alpha.dtype, device=dev)
        vals = (w * alpha[..., torch.as_tensor(cells, device=dev)]).sum(-1)
        G = torch.zeros(alpha.shape[:-1]
                        + (self.n_constraints * self.fine.n_nodes,),
                        dtype=alpha.dtype, device=dev)
        G[..., torch.as_tensor(keys, device=dev)] = vals
        return G.reshape(alpha.shape[:-1]
                         + (self.n_constraints, self.fine.n_nodes))

    def assemble_reduced(self, alpha: torch.Tensor, bc_values: torch.Tensor,
                         free_dofs: np.ndarray, constrained_dofs: np.ndarray):
        """(Gamma_reduced (..., n_constraints, n_free), alpha_rhs (...,
        n_constraints)): the constraints on the free dofs and the right-hand
        side carrying the Dirichlet values."""
        G = self.gamma_full(alpha)
        dev = G.device
        G_red = G[..., torch.as_tensor(free_dofs, device=dev)]
        G_con = G[..., torch.as_tensor(constrained_dofs, device=dev)]
        rhs = -(G_con @ bc_values.to(G.dtype)[..., None])[..., 0]
        return G_red, rhs
