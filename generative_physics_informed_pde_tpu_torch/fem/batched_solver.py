"""Batch-last ("structure-of-arrays") batched full-order solver, forward.

Port of ``generative_physics_informed_pde_tpu/fem/batched_solver.py``:
arrays are laid out ``(Ny, Nx, B)`` with the batch last, per-sample CG
scalars reduce over the two spatial axes, and every stencil apply of the
solve -- the PCG matvec and the rhs -- goes through the stencil kernel of
``ops/stencil.py``.  Jacobi preconditioning only: the ``'auto'`` gate
resolves to Jacobi below 64^2, and the multigrid V-cycle is not ported yet.

Left out as TPU-only: ``precond_dtype`` (a bf16 V-cycle), the
``optimization_barrier`` fence around the preconditioner and the
``effective_platform()`` gates.  The implicit-function VJP is not ported
yet; the solve runs without autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .assembly import StencilOperator, _OFFSETS
from ..ops.stencil import apply_stencil


def _apply_stencil_blast(coefs, v):
    """coefs (7, Ny, Nx, B), v (Ny, Nx, B) -> (Ny, Nx, B), plain torch."""
    Ny, Nx = v.shape[0], v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(v)
    for k, (oy, ox) in enumerate(_OFFSETS):
        out = out + coefs[k] * vp[1 + oy:1 + oy + Ny, 1 + ox:1 + ox + Nx, :]
    return out


def _batched_pcg(matvec, b, mask, precond, tol, maxiter):
    """PCG with per-sample scalars on (Ny, Nx, B) arrays, the reference's
    ``fused_rr`` form: the residual norm is carried as a per-sample scalar
    computed beside ``gamma = <r, z>``.  Every sample iterates until all
    have converged (``rr <= tol^2 |b|^2``) or ``maxiter`` is reached; the
    reference's while_loop condition is a host check per iteration.
    Returns ``(x, iterations)``."""

    def dot(a, c):
        return (a * c).sum(dim=(0, 1))  # (B,)

    b = mask * b
    bnorm2 = dot(b, b)
    atol2 = (tol ** 2) * bnorm2
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    gamma = dot(r, z)
    rr = bnorm2
    k = 0
    while k < maxiter and bool((rr > atol2).any()):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = gamma / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = dot(r, z)
        rr = dot(r, r)
        beta = gamma_new / torch.where(gamma == 0, 1.0, gamma)
        p = z + beta * p
        gamma = gamma_new
        k += 1
    return x, k


class BatchedFomSolver:
    """``solve(alphas, bc_values) -> Y_free`` for a whole batch: alphas
    (B, n_cells), bc_values (B, n_constrained) -> (B, n_free), on the
    device the inputs lie on.  ``iterations`` holds the PCG iteration
    count of the last call."""

    def __init__(self, op: StencilOperator, profile, *, tol=None,
                 maxiter=None, precond: str = "auto"):
        grid = op.grid
        if precond not in ("auto", "mg", "jacobi"):
            raise ValueError(f"precond must be 'auto', 'mg' or 'jacobi', "
                             f"got {precond!r}")
        from .bc import DirichletProfile
        std_profile = np.array_equal(
            np.asarray(profile.free_mask),
            np.asarray(DirichletProfile(grid).free_mask))
        mg_ok = (min(grid.nx, grid.ny) >= 64 and grid.nx % 2 == 0
                 and grid.ny % 2 == 0 and std_profile)
        if precond == "mg" or (precond == "auto" and mg_ok):
            raise NotImplementedError(
                f"the multigrid preconditioner the reference uses at "
                f"{grid.nx}x{grid.ny} is not ported yet; pass "
                "precond='jacobi'")
        self.op = op
        self.Ny, self.Nx = grid.ny + 1, grid.nx + 1
        self.tol = tol
        self.maxiter = maxiter or max(200, 30 * max(grid.nx, grid.ny))
        self.free_mask = np.asarray(profile.free_mask, dtype=np.float64
                                    ).reshape(self.Ny, self.Nx, 1)
        self.free_dofs = np.asarray(profile.free_dofs)
        self.con_dofs = np.asarray(profile.constrained_dofs)
        self.iterations = None

    def _to_blast(self, flat):
        """(B, n_nodes) -> contiguous (Ny, Nx, B)"""
        return flat.reshape(-1, self.Ny, self.Nx).permute(1, 2, 0).contiguous()

    def _from_blast(self, grids):
        return grids.permute(2, 0, 1).reshape(-1, self.Ny * self.Nx)

    @torch.no_grad()
    def __call__(self, alphas: torch.Tensor, bc_values: torch.Tensor):
        dtype, device = alphas.dtype, alphas.device
        tol = self.tol if self.tol is not None else (
            1e-10 if dtype == torch.float64 else 2e-6)
        B = alphas.shape[0]
        # (B, 7, Ny, Nx) -> (7, Ny, Nx, B), made contiguous once per solve
        coefs = self.op.coefficients(alphas).permute(1, 2, 3, 0).contiguous()
        mask = torch.as_tensor(self.free_mask, dtype=dtype, device=device)
        diag = coefs[0]
        inv_diag = mask / torch.where(diag <= 0, 1.0, diag)

        bc_full = torch.zeros((B, self.Ny * self.Nx), dtype=dtype,
                              device=device)
        bc_full[:, torch.as_tensor(self.con_dofs, device=device)] = \
            bc_values.to(dtype)
        bc_g = self._to_blast(bc_full)
        rhs = -apply_stencil(coefs, bc_g, torch.ones_like(mask))
        y_free_g, self.iterations = _batched_pcg(
            lambda v: apply_stencil(coefs, mask * v, mask), rhs, mask,
            lambda r: inv_diag * r, tol, self.maxiter)
        y_full = self._from_blast(y_free_g + bc_g)
        return y_full[:, torch.as_tensor(self.free_dofs, device=device)]


def make_batched_fom_solver(op: StencilOperator, profile, *, tol=None,
                            maxiter=None, precond: str = "auto"
                            ) -> BatchedFomSolver:
    """Build the batched forward solver (see :class:`BatchedFomSolver`)."""
    return BatchedFomSolver(op, profile, tol=tol, maxiter=maxiter,
                            precond=precond)
