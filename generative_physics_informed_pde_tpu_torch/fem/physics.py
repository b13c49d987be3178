"""Linear elliptic (Darcy) physics on structured grids.

Port of ``LinearEllipticPhysics`` and ``make_fom_rom_pair`` from
``generative_physics_informed_pde_tpu/fem/physics.py``: the batched
full-order solve (differentiable through its implicit-function VJP), the
free/constrained dof sets, the coarse assembly tensor, the dense direct
solve used as an oracle, and the reduced-system helpers (matrix-free
``K_ff``, the effective force, the scatter of a restricted solution) whose
stiffness applies run on K1.  The single-sample solve is not ported yet.
"""

from __future__ import annotations

from functools import cached_property

import numpy as np
import torch

from .grid import StructuredTriGrid
from .assembly import StencilOperator, assembly_tensor, dense_stiffness
from .bc import FAMILIES, DirichletProfile
from .pixels import PixelConverter
from ..utils.device import check_on, resolve_device


class LinearEllipticPhysics:
    """One discretisation level of the Darcy problem on ``device``
    (default ``"cuda"``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, identifier: str, physics_id: str,
                 grid: StructuredTriGrid, *, cg_tol: float | None = None,
                 cg_maxiter: int | None = None, device="cuda"):
        physics_id = physics_id.upper()
        if physics_id not in FAMILIES:
            raise NotImplementedError(physics_id)
        self.identifier = identifier
        self.physics_id = physics_id
        self.grid = grid
        self.device = resolve_device(device)
        self.op = StencilOperator(grid)
        self.profile = DirichletProfile(grid)
        self.pixels = PixelConverter(grid)
        self._cg_tol = cg_tol
        self._cg_maxiter = cg_maxiter

    @property
    def constrained_dofs(self) -> np.ndarray:
        return self.profile.constrained_dofs

    @property
    def free_dofs(self) -> np.ndarray:
        return self.profile.free_dofs

    @property
    def dim_out(self) -> int:
        return self.profile.n_free

    @cached_property
    def assembly_tensor(self) -> np.ndarray:
        """Dense M[i,j,c] (coarse grids only)."""
        return assembly_tensor(self.grid)

    @cached_property
    def _batched_solver(self):
        from .batched_solver import make_batched_fom_solver

        return make_batched_fom_solver(self.op, self.profile,
                                       tol=self._cg_tol,
                                       maxiter=self._cg_maxiter)

    def solve_batched(self, alphas: torch.Tensor,
                      bc_values: torch.Tensor) -> torch.Tensor:
        """Batched differentiable solve: (N, n_cells), (N, n_constrained)
        -> (N, n_free), one batch-last PCG (the multigrid V-cycle on even
        grids of min dim >= 64, else Jacobi) whose stencil applies run on
        the CUDA kernel (its plain version on the CPU); gradients with
        respect to both inputs come from one adjoint PCG.  Inputs lie on
        the physics' device."""
        check_on(alphas, self.device, "alphas")
        check_on(bc_values, self.device, "bc_values")
        return self._batched_solver(alphas, bc_values)

    @property
    def last_iterations(self):
        """PCG iterations of the last ``solve_batched`` call."""
        return self._batched_solver.iterations

    def solve_direct(self, alpha, bc_values, only_free_dofs: bool = True):
        """Dense direct solve of one sample, host numpy float64 (oracle)."""
        K = dense_stiffness(self.grid, np.asarray(alpha, dtype=np.float64))
        free = self.free_dofs
        con = self.constrained_dofs
        vals = np.asarray(bc_values, dtype=np.float64)
        f_eff = -K[np.ix_(free, con)] @ vals
        y_f = np.linalg.solve(K[np.ix_(free, free)], f_eff)
        if only_free_dofs:
            return y_f
        out = np.zeros(self.grid.n_nodes)
        out[con] = vals
        out[free] = y_f
        return out

    # -------------------------------------------- reduced system interface
    def reduced_system_matvec(self, alpha: torch.Tensor):
        """Matrix-free ``K_ff`` on full dof vectors: ``v_full (...,
        n_nodes) -> m * K(alpha) (m * v_full)`` with ``m`` the free mask;
        the coefficients are built once here."""
        coefs = self.op.coefficients(alpha)
        m = torch.as_tensor(self.profile.free_mask, dtype=coefs.dtype,
                            device=coefs.device)

        def matvec_full(v_full):
            return m * self.op.to_flat(
                self.op.apply_coeff(coefs, self.op.to_nodegrid(m * v_full)))

        return matvec_full

    def effective_force(self, alpha: torch.Tensor, bc_values: torch.Tensor,
                        f_full=None) -> torch.Tensor:
        """``f_eff = f_f - K_fc y_c`` on the full grid, zero at the
        constrained dofs: alpha (..., n_cells), bc_values (...,
        n_constrained) -> (..., n_nodes)."""
        bc_full = self.profile.scatter_full(bc_values)
        if f_full is None:
            f_full = torch.zeros_like(bc_full)
        m = torch.as_tensor(self.profile.free_mask, dtype=bc_full.dtype,
                            device=bc_full.device)
        return m * (f_full - self.op.matvec(alpha, bc_full))

    def scatter_restricted_solution(self, y_free, bc_values) -> torch.Tensor:
        """Free-dof solution + Dirichlet values -> full vector."""
        return self.profile.scatter_full(bc_values, free_values=y_free)

    def __repr__(self):  # pragma: no cover
        return (f"LinearEllipticPhysics('{self.identifier}', "
                f"'{self.physics_id}', {self.grid!r}, {self.device})")


def make_fom_rom_pair(physics_id: str, nx_rom: int, ny_rom: int,
                      num_refines: int, *, device="cuda",
                      **solver_kwargs) -> dict:
    """The fom/rom physics dict and the interpolator W (n_free_fom,
    n_rom_nodes), as the reference model factory builds them."""
    from .interpolation import physics_resolution_interpolator

    device = resolve_device(device)
    rom_grid = StructuredTriGrid(nx_rom, ny_rom)
    fom_grid = rom_grid.refined(num_refines)
    physics = {
        "fom": LinearEllipticPhysics("fom", physics_id, fom_grid,
                                     device=device, **solver_kwargs),
        "rom": LinearEllipticPhysics("rom", physics_id, rom_grid,
                                     device=device, **solver_kwargs),
    }
    physics["W"] = physics_resolution_interpolator(
        rom_grid, fom_grid, free_dofs=physics["fom"].free_dofs)
    return physics
