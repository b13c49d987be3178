"""Coarse->fine P1 interpolation operators.

The port's own copy of ``generative_physics_informed_pde_tpu/fem/
interpolation.py`` (pure numpy).  Replaces the reference's PETSc-backed
basis-function
matrix (``AssembleBasisFunctionMatrix``, fawkes/utils.py:115-192, used by
``PhysicsResolutionInterpolator``, bottleneck/components.py:13-67): on the
structured triangulation every coarse P1 basis function has a closed form,
so ``W`` is evaluated analytically at the fine node coordinates -- no PETSc,
no mesh queries.
"""

from __future__ import annotations

import numpy as np

from .grid import StructuredTriGrid


def p1_interpolation_matrix(coarse: StructuredTriGrid, points: np.ndarray) -> np.ndarray:
    """(n_points, coarse.n_nodes) float64 matrix evaluating coarse P1 basis
    functions at arbitrary points.

    Points on the lower triangle of a coarse square (fx >= fy, matching the
    right-diagonal split) get barycentric weights w.r.t. vertices
    (v00, v10, v11); otherwise (v00, v11, v01).
    """
    pts = np.asarray(points, dtype=np.float64)
    n = pts.shape[0]
    ix, iy, fx, fy = coarse.locate(pts)
    W = np.zeros((n, coarse.n_nodes), dtype=np.float64)

    v00 = coarse.node_id(ix, iy)
    v10 = coarse.node_id(ix + 1, iy)
    v11 = coarse.node_id(ix + 1, iy + 1)
    v01 = coarse.node_id(ix, iy + 1)

    lower = fx >= fy
    rows = np.arange(n)

    # lower triangle barycentric coords for (v00, v10, v11):
    #   u = 1 - fx, v = fx - fy, w = fy
    lw = np.stack([1 - fx, fx - fy, fy], axis=1)
    lv = np.stack([v00, v10, v11], axis=1)
    # upper triangle (v00, v11, v01): u = 1 - fy, v = fx, w = fy - fx
    uw = np.stack([1 - fy, fx, fy - fx], axis=1)
    uv = np.stack([v00, v11, v01], axis=1)

    wts = np.where(lower[:, None], lw, uw)
    vids = np.where(lower[:, None], lv, uv)
    for k in range(3):
        np.add.at(W, (rows, vids[:, k]), wts[:, k])
    return W


def physics_resolution_interpolator(coarse: StructuredTriGrid,
                                    fine: StructuredTriGrid,
                                    free_dofs: np.ndarray | None = None) -> np.ndarray:
    """``W`` (n_fine_points, n_coarse_nodes): coarse nodal vectors -> fine
    nodal vectors, restricted to fine free dofs when given (reference:
    bottleneck/components.py:38-63, mode 'ManualInterpolation' with
    only_free_dofs=True)."""
    points = fine.node_coords
    if free_dofs is not None:
        points = points[np.asarray(free_dofs)]
    return p1_interpolation_matrix(coarse, points)
