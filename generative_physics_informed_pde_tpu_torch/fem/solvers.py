"""Solvers of the embedded FEM problems.

Port of ``generative_physics_informed_pde_tpu/fem/solvers.py``:

* ``stiffness_from_tensor`` and ``rom_solve``, the dense coarse (ROM)
  path: the symmetric reduced system ``K_ff y_f = F_f - K_fc y_c``
  through a batched Cholesky factorisation (``K_ff`` is SPD for positive
  conductivities);
* ``cg`` and ``make_fom_solver``, the matrix-free full-order path: a
  Jacobi-PCG on the stencil operator, whose applies are launches of the
  kernel K1, differentiable through its implicit-function VJP.  A batch
  of systems runs as one CG whose systems each stop on their own
  criterion (the reference's ``vmap`` of one solve).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .assembly import StencilOperator
from ..ops.stencil import apply_stencil


def stiffness_from_tensor(M: torch.Tensor, alpha: torch.Tensor,
                          bc_dofs) -> torch.Tensor:
    """Batched dense stiffness ``K = M . alpha`` with the Dirichlet rows
    replaced by identity rows.  M: (d, d, c), alpha: (..., c)."""
    K = torch.einsum("ijc,...c->...ij", M, alpha)
    d = K.shape[-1]
    row_is_bc = torch.zeros(d, dtype=torch.bool, device=K.device)
    row_is_bc[torch.as_tensor(np.asarray(bc_dofs), device=K.device)] = True
    eye = torch.eye(d, dtype=K.dtype, device=K.device)
    return torch.where(row_is_bc[:, None], eye, K)


def rom_solve(M: torch.Tensor, alpha: torch.Tensor, F: torch.Tensor,
              bc_dofs) -> torch.Tensor:
    """Batched coarse solve ``K(alpha) y = F``.

    alpha: (..., c) positive conductivities; F: (..., d) forces that carry
    the Dirichlet values at ``bc_dofs`` (host numpy, as the reference keeps
    them).  Returns (..., d).  A system whose Cholesky factorisation fails
    (not positive definite in the working precision) gives NaN, as
    ``jnp.linalg.cholesky`` does in the JAX package, instead of raising;
    ``cholesky_ex`` does not wait for the device.  The reference's TPU
    ``max_chunk`` batching is a TPU runtime workaround and is left out.
    """
    dt = torch.promote_types(torch.promote_types(M.dtype, alpha.dtype),
                             F.dtype)
    M, alpha, F = M.to(dt), alpha.to(dt), F.to(dt)
    bc = np.asarray(bc_dofs)
    d = F.shape[-1]
    free = np.setdiff1d(np.arange(d), bc)
    FREE = torch.as_tensor(free, device=F.device)
    BC = torch.as_tensor(bc, device=F.device)
    F = F.expand(alpha.shape[:-1] + (d,))
    K = torch.einsum("ijc,...c->...ij", M, alpha)
    Kff = K[..., FREE[:, None], FREE[None, :]]
    L, info = torch.linalg.cholesky_ex(Kff)
    L = torch.where((info != 0)[..., None, None],
                    torch.full_like(L, float("nan")), L)
    rhs = F[..., FREE]
    if len(bc):
        Kfc = K[..., FREE[:, None], BC[None, :]]
        rhs = rhs - torch.einsum("...ij,...j->...i", Kfc, F[..., BC])
    yf = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    out = F.clone() if len(bc) else torch.zeros_like(F)
    out[..., FREE] = yf
    return out


# --------------------------------------------------------------------------
# Matrix-free CG (fine/FOM) path
# --------------------------------------------------------------------------

class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor


def cg(matvec, b, x0=None, *, precond=None, tol=1e-10,
       maxiter=1000) -> CGResult:
    """Preconditioned conjugate gradients on tensors shaped like ``b``.

    Stops when ``||r||^2 <= (tol ||b||)^2`` or after ``maxiter``
    iterations.  The loop condition is read on the host once per iteration
    (the reference's ``lax.while_loop`` condition).  With ``x0=None`` the
    start is zero and the first residual is ``b`` itself, without an
    apply."""
    if precond is None:
        precond = lambda r: r  # noqa: E731

    def dot(a, c):
        return (a * c).sum()

    atol2 = (tol * torch.sqrt(dot(b, b))) ** 2
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = precond(r)
    p = z
    gamma = dot(r, z)
    k = 0
    while k < maxiter and bool(dot(r, r) > atol2):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = gamma / torch.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        gamma_new = dot(r, z)
        beta = gamma_new / torch.where(gamma == 0, 1.0, gamma)
        p = z + beta * p
        gamma = gamma_new
        k += 1
    return CGResult(x, k, torch.sqrt(dot(r, r)))


def _cg_per_system(matvec, b, inv_diag, tol, maxiter):
    """Jacobi-PCG of B independent systems on batch-last (Ny, Nx, B)
    arrays, as the reference's ``vmap`` of its ``while_loop`` runs it: the
    loop goes on while any system is active (not converged, fewer than
    ``maxiter`` iterations), every iteration updates all of them, and a
    system that has stopped keeps its state through a select.  Each
    system therefore stops on its own criterion and equals its solve
    alone.  One host read of the active flags per iteration.  Returns
    ``(x, iterations per system (B,))``."""

    def dot(a, c):
        return (a * c).sum(dim=(0, 1))  # (B,)

    atol2 = (tol * torch.sqrt(dot(b, b))) ** 2
    x = torch.zeros_like(b)
    r = b  # x0 = 0: no apply for the first residual
    z = inv_diag * r
    p = z
    gamma = dot(r, z)
    k = torch.zeros(b.shape[-1], dtype=torch.long, device=b.device)
    active = dot(r, r) > atol2
    while bool(active.any()):
        Ap = matvec(p)
        denom = dot(p, Ap)
        alpha = gamma / torch.where(denom == 0, 1.0, denom)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = inv_diag * r_new
        gamma_new = dot(r_new, z)
        beta = gamma_new / torch.where(gamma == 0, 1.0, gamma)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
        k = k + active
        active = (k < maxiter) & (dot(r, r) > atol2)
    return x, k


class _FomSolve(torch.autograd.Function):
    """``(alpha, f_full, bc_full) -> y_full`` with the reference's
    ``custom_vjp``: the backward is one adjoint CG per system."""

    @staticmethod
    def forward(ctx, solver, alpha, f_full, bc_full):
        coefs = solver._coefs(alpha)
        dtype = coefs.dtype
        bc_g = solver._to_blast(bc_full.to(dtype))
        rhs = solver._to_blast(f_full.to(dtype)) - apply_stencil(
            coefs, bc_g, torch.ones_like(solver._mask(dtype, coefs.device)))
        y_free, solver.iterations = solver._solve_free(coefs, rhs)
        y = solver._from_blast(y_free + bc_g, alpha.dim() == 1)
        ctx.solver = solver
        ctx.dtypes = (alpha.dtype, f_full.dtype, bc_full.dtype)
        ctx.save_for_backward(y, coefs)
        return y

    @staticmethod
    def backward(ctx, ybar):
        s = ctx.solver
        y, coefs = ctx.saved_tensors
        single = y.dim() == 1
        ybar_g = s._to_blast(ybar.to(coefs.dtype))
        # adjoint solve K_ff^T lam = ybar_f (K is symmetric)
        lam_g, s.adjoint_iterations = s._solve_free(coefs, ybar_g)
        lam = s._from_blast(lam_g, single)
        # d/dalpha of -lam^T K(alpha) y; y carries the BC values, so this
        # covers both the K_ff y_f and the K_fc y_c dependence
        alpha_bar = -s.op.cell_bilinear(lam, y)
        m = s._mask(coefs.dtype, coefs.device)
        Klam = s._from_blast(apply_stencil(coefs, lam_g, torch.ones_like(m)),
                             single)
        bc_bar = (1.0 - m.reshape(-1)) * (ybar - Klam)
        # cotangents in the PRIMAL dtypes (a mixed f32-alpha / f64-bc call)
        a_dt, f_dt, bc_dt = ctx.dtypes
        return (None, alpha_bar.to(a_dt), lam.to(f_dt), bc_bar.to(bc_dt))


class FomSolver:
    """``solve(alpha, f_full, bc_full) -> y_full`` on one grid and one
    constraint set (see :func:`make_fom_solver`).  ``iterations`` holds
    the CG iteration count(s) of the last forward and
    ``adjoint_iterations`` those of the last backward: an int for one
    system, a (B,) tensor for a batch."""

    def __init__(self, op: StencilOperator, free_mask_np, *, tol=None,
                 maxiter=None):
        g = op.grid
        self.op = op
        self.Ny, self.Nx = g.ny + 1, g.nx + 1
        # Jacobi-PCG on the 2D elliptic stencil converges in O(grid side)
        # iterations; 30x the side is a comfortable ceiling
        self.maxiter = maxiter or max(200, 30 * max(g.nx, g.ny))
        self.tol = tol
        self._free_mask_np = np.asarray(free_mask_np, dtype=np.float64
                                        ).reshape(self.Ny, self.Nx, 1)
        # the mask per (dtype, device): no tensor of one device leaks into
        # a call on another
        self._masks = {}
        self.iterations = None
        self.adjoint_iterations = None

    def _mask(self, dtype, device):
        key = (dtype, device)
        if key not in self._masks:
            self._masks[key] = torch.as_tensor(self._free_mask_np,
                                               dtype=dtype, device=device)
        return self._masks[key]

    def _to_blast(self, flat):
        """(n_nodes,) -> (Ny, Nx, 1), (B, n_nodes) -> contiguous
        (Ny, Nx, B)."""
        if flat.dim() == 1:
            return flat.reshape(self.Ny, self.Nx, 1)
        return flat.reshape(-1, self.Ny, self.Nx).permute(1, 2, 0
                                                          ).contiguous()

    def _from_blast(self, grids, single):
        if single:
            return grids.reshape(-1)
        return grids.permute(2, 0, 1).reshape(-1, self.Ny * self.Nx)

    def _coefs(self, alpha):
        """(n_cells,) or (B, n_cells) -> contiguous (7, Ny, Nx, B), B = 1
        for one system."""
        c = self.op.coefficients(alpha)
        if alpha.dim() == 1:
            return c.unsqueeze(-1).contiguous()
        return c.permute(1, 2, 3, 0).contiguous()

    def _solve_free(self, coefs, rhs):
        """CG on the masked operator ``m K (m v)`` (one K1 launch, its mask
        fused) with the Jacobi preconditioner; the tolerance is 1e-10 in
        f64 and 2e-6 in f32 unless given.  -> (x, iterations)."""
        m = self._mask(coefs.dtype, coefs.device)
        diag = coefs[0]
        inv_diag = m / torch.where(diag <= 0, 1.0, diag)
        tol = self.tol if self.tol is not None else (
            1e-10 if coefs.dtype == torch.float64 else 2e-6)
        x, k = _cg_per_system(lambda v: apply_stencil(coefs, m * v, m),
                              m * rhs, inv_diag, tol, self.maxiter)
        return x, (int(k[0]) if k.numel() == 1 else k)

    def __call__(self, alpha, f_full, bc_full):
        """alpha (n_cells,), f_full and bc_full (n_nodes,) -> y_full
        (n_nodes,); or each with a leading batch dim B for B independent
        systems, each stopped on its own criterion."""
        return _FomSolve.apply(self, alpha, f_full, bc_full)


def make_fom_solver(op: StencilOperator, free_mask_np, *, tol=None,
                    maxiter=None) -> FomSolver:
    """Differentiable full-order solver for one grid and BC family:
    ``solve(alpha, f_full, bc_full) -> y_full`` with ``alpha`` (n_cells,)
    positive conductivities, ``f_full`` (n_nodes,) the raw force,
    ``bc_full`` (n_nodes,) the Dirichlet values at the constrained dofs
    (zero elsewhere); ``y_full`` carries the Dirichlet values.  The
    elimination ``K_ff y_f = f_f - K_fc y_c`` runs matrix-free on the
    masked operator ``m K (m v)``, SPD on the free subspace, every apply
    one launch of the stencil kernel K1 (its plain version on the CPU).
    Gradients with respect to all three inputs come from the implicit
    function theorem: one adjoint CG and a per-cell contraction."""
    return FomSolver(op, free_mask_np, tol=tol, maxiter=maxiter)
