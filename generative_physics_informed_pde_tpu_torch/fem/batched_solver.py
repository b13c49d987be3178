"""Batch-last ("structure-of-arrays") batched full-order solver, with its
implicit-function VJP.

Port of ``generative_physics_informed_pde_tpu/fem/batched_solver.py``:
arrays are laid out ``(Ny, Nx, B)`` with the batch last, per-sample CG
scalars reduce over the two spatial axes, and every stencil apply of the
solve -- the PCG matvec, the rhs, and in the backward the adjoint PCG's
matvec and the ``K lambda`` term -- goes through a stencil kernel of
``ops/stencil.py``: the 7-grid ``apply_stencil`` by default, the symmetric
4-grid ``apply_stencil_sym`` with ``sym=True``.  The preconditioner is
Jacobi or the multigrid V-cycle of ``fem/multigrid.py`` (whose smoother
and residual run on ``apply_stencil``), chosen by the reference's
``'auto'`` gate: multigrid at min dim >= 64 with even dims and the
standard profile.

The solve is a ``torch.autograd.Function`` (the reference's
``jax.custom_vjp``): its backward is one adjoint batched PCG on the same
operator, preconditioned by the forward's V-cycle levels, plus two cheap
contractions.  The stiffness operator is self-adjoint and the reference
has no backward Pallas kernel, so the backward reuses the forward's
stencil kernels and needs none of its own.

``precond_dtype`` is the V-cycle's dtype as in the reference: 'bfloat16',
'float32' or 'float64', None meaning 'float32' (the reference's default
off a TPU); an f64 solve runs the f64 V-cycle whatever it says (the
reference's ``_mg_for_dtype``).  The outer PCG always runs in the data's
dtype.

Left out as TPU-only: the ``optimization_barrier`` fence around the
preconditioner, the ``effective_platform()`` gates and the ``use_pallas``
switch (on a card the apply is always the hand-written kernel).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .assembly import StencilOperator, _OFFSETS, _SYM_DIRS
from ..ops.stencil import apply_stencil, apply_stencil_sym
from ..utils.time import span


def _apply_stencil_blast(coefs, v):
    """coefs (7, Ny, Nx, B), v (Ny, Nx, B) -> (Ny, Nx, B), plain torch."""
    Ny, Nx = v.shape[0], v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
    out = torch.zeros_like(v)
    for k, (oy, ox) in enumerate(_OFFSETS):
        out = out + coefs[k] * vp[1 + oy:1 + oy + Ny, 1 + ox:1 + ox + Nx, :]
    return out


def _apply_stencil_sym_blast(coefs4, v):
    """Symmetric-form apply, plain torch: coefs4 (4, Ny, Nx, B) =
    [diag, c_N, c_E, c_D], v (Ny, Nx, B) -> (Ny, Nx, B).  Each
    off-diagonal grid serves the +dir coupling and, shifted, the -dir
    one."""
    Ny, Nx = v.shape[0], v.shape[1]
    vp = torch.nn.functional.pad(v, (0, 0, 1, 1, 1, 1))
    out = coefs4[0] * v
    for k, (oy, ox) in enumerate(_SYM_DIRS):
        c = coefs4[1 + k]
        cp = torch.nn.functional.pad(c, (0, 0, 1, 1, 1, 1))
        out = out + c * vp[1 + oy:1 + oy + Ny, 1 + ox:1 + ox + Nx, :]
        out = out + (cp[1 - oy:1 - oy + Ny, 1 - ox:1 - ox + Nx, :]
                     * vp[1 - oy:1 - oy + Ny, 1 - ox:1 - ox + Nx, :])
    return out


def _batched_pcg(matvec, b, mask, precond, tol, maxiter):
    """PCG with per-sample scalars on (Ny, Nx, B) arrays, the reference's
    ``fused_rr`` form: the residual norm is carried as a per-sample scalar
    computed beside ``gamma = <r, z>``.  Every sample iterates until all
    have converged (``rr <= tol^2 |b|^2``) or ``maxiter`` is reached; the
    reference's while_loop condition is a host check per iteration
    (span ``pcg.stop_check``, beside each loop body's ``pcg.iteration``).
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
    while k < maxiter and _unconverged(rr, atol2):
        with span("pcg.iteration"):
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


def _unconverged(rr, atol2) -> bool:
    """The PCG's stop check: a host read that waits for the device."""
    with span("pcg.stop_check"):
        return bool((rr > atol2).any())


class _Solve(torch.autograd.Function):
    """``(alphas, bc_values) -> Y_free`` with the implicit-function VJP
    (reference ``_fwd``/``_bwd``, ``batched_solver.py:296-333``)."""

    @staticmethod
    def forward(ctx, solver, alphas, bc_values):
        y_full, coefs, mask, tol, levels = solver._forward(alphas, bc_values)
        ctx.solver, ctx.tol, ctx.levels = solver, tol, levels
        ctx.dtypes = (alphas.dtype, bc_values.dtype)
        ctx.save_for_backward(y_full, coefs, mask)
        return y_full[:, solver._idx("free", y_full.device)]

    @staticmethod
    def backward(ctx, ybar):
        # autograd runs a card's backward on its device thread, where
        # this span opens a root of its own
        with span("solve.adjoint"):
            return _Solve._backward(ctx, ybar)

    @staticmethod
    def _backward(ctx, ybar):
        s = ctx.solver
        y_full, coefs, mask = ctx.saved_tensors
        apply = s._apply()
        B, device = ybar.shape[0], ybar.device
        ybar_full = torch.zeros((B, s.Ny * s.Nx), dtype=ybar.dtype,
                                device=device)
        ybar_full[:, s._idx("free", device)] = ybar
        # the adjoint PCG reuses the forward's V-cycle levels
        precond, _ = s._precond(coefs, mask, ctx.levels)
        lam_g, s.adjoint_iterations = _batched_pcg(
            lambda v: apply(coefs, mask * v, mask), s._to_blast(ybar_full),
            mask, precond, ctx.tol, s.maxiter)
        alpha_bar = -s.op.cell_bilinear(s._from_blast(lam_g), y_full)
        # bc gradient: the direct part plus the coupling through K
        Klam = s._from_blast(apply(coefs, lam_g, torch.ones_like(mask)))
        m_flat = mask.reshape(1, -1)
        bc_bar = ((1.0 - m_flat) * (ybar_full - Klam))[
            :, s._idx("con", device)]
        # cotangents carry their primal's dtype (a mixed f32-alphas /
        # f64-bc call gets an f64 bc gradient)
        return (None, alpha_bar.to(ctx.dtypes[0]),
                bc_bar.to(ctx.dtypes[1]))


class BatchedFomSolver:
    """``solve(alphas, bc_values) -> Y_free`` for a whole batch: alphas
    (B, n_cells), bc_values (B, n_constrained) -> (B, n_free), on the
    device the inputs lie on, differentiable with respect to both.
    ``iterations`` holds the forward PCG iteration count of the last call
    and ``adjoint_iterations`` that of the last backward."""

    def __init__(self, op: StencilOperator, profile, *, tol=None,
                 maxiter=None, precond: str = "auto",
                 precond_dtype: str | None = None, sym: bool = False):
        from .multigrid import MultigridPreconditioner, check_precond_dtype

        grid = op.grid
        if precond not in ("auto", "mg", "jacobi"):
            raise ValueError(f"precond must be 'auto', 'mg' or 'jacobi', "
                             f"got {precond!r}")
        # the reference's None is bfloat16 on a TPU up to 256^2; there is
        # no TPU here, so None is its float32 of every other platform
        precond_dtype = check_precond_dtype(
            "float32" if precond_dtype is None else precond_dtype)
        # the V-cycle's level masks assume the standard left/right
        # Dirichlet profile; for any other constraint set multigrid would
        # smooth the wrong dof set
        from .bc import DirichletProfile
        std_profile = np.array_equal(
            np.asarray(profile.free_mask),
            np.asarray(DirichletProfile(grid).free_mask))
        if precond == "auto":
            mg_ok = (min(grid.nx, grid.ny) >= 64 and grid.nx % 2 == 0
                     and grid.ny % 2 == 0 and std_profile)
            precond = "mg" if mg_ok else "jacobi"
            if not mg_ok and min(grid.nx, grid.ny) >= 64:
                if grid.nx % 2 or grid.ny % 2:
                    why = ("an odd grid dimension prevents coarsening; pad "
                           "the grid to even dims to enable it")
                else:
                    why = ("a non-standard constraint profile (the V-cycle "
                           "level masks assume the left/right "
                           "DirichletProfile)")
                warnings.warn(
                    f"auto precond chose Jacobi-PCG for {grid.nx}x{grid.ny} "
                    f"because {why}; at this size multigrid-PCG needs far "
                    "fewer iterations where it applies.", stacklevel=2)
        self.mg = None
        if precond == "mg":
            if not std_profile:
                raise ValueError(
                    "precond='mg' requires the standard left/right "
                    "DirichletProfile (the V-cycle level masks assume it); "
                    "use 'jacobi' for custom constraint sets")
            # _precond switches f64 solves to the float64 V-cycle
            self.mg = MultigridPreconditioner.for_grid(grid,
                                                       dtype=precond_dtype)
            maxiter = maxiter or 60
        # the reference refuses sym=True at >= 256^2 on a TPU, a runtime
        # fault of that chip; no such refusal here
        self.op = op
        self.sym = bool(sym)
        self.Ny, self.Nx = grid.ny + 1, grid.nx + 1
        self.tol = tol
        self.maxiter = maxiter or max(200, 30 * max(grid.nx, grid.ny))
        self.free_mask = np.asarray(profile.free_mask, dtype=np.float64
                                    ).reshape(self.Ny, self.Nx, 1)
        self.free_dofs = np.asarray(profile.free_dofs)
        self.con_dofs = np.asarray(profile.constrained_dofs)
        self.iterations = None
        self.adjoint_iterations = None

    def _apply(self):
        """The stencil apply of every step of the solve (looked up per
        call, so a caller may route it through the plain version)."""
        return apply_stencil_sym if self.sym else apply_stencil

    def _idx(self, which, device):
        dofs = self.free_dofs if which == "free" else self.con_dofs
        return torch.as_tensor(dofs, device=device)

    def _to_blast(self, flat):
        """(B, n_nodes) -> contiguous (Ny, Nx, B)"""
        return flat.reshape(-1, self.Ny, self.Nx).permute(1, 2, 0).contiguous()

    def _from_blast(self, grids):
        return grids.permute(2, 0, 1).reshape(-1, self.Ny * self.Nx)

    def _precond(self, coefs, mask, levels=None, alphas=None):
        """-> (precond r -> z, V-cycle levels): Jacobi on ``coefs[0]``, or
        the V-cycle on ``levels`` (built from ``alphas`` when None; the
        VJP passes the forward's).  An f64 solve runs the f64 V-cycle, as
        the reference's does (``_mg_for_dtype``)."""
        if self.mg is None:
            diag = coefs[0]
            inv_diag = mask / torch.where(diag <= 0, 1.0, diag)
            return (lambda r: inv_diag * r), None
        mg = self.mg
        if coefs.dtype == torch.float64:
            mg = dataclasses.replace(mg, dtype="float64")
        if levels is None:
            levels = mg.setup(alphas)
        return (lambda r: mg.apply(levels, r)), levels

    def _forward(self, alphas, bc_values):
        """The forward solve: -> (y_full (B, n_nodes), coefs, mask, tol,
        V-cycle levels or None)."""
        with span("solve"):
            dtype, device = alphas.dtype, alphas.device
            tol = self.tol if self.tol is not None else (
                1e-10 if dtype == torch.float64 else 2e-6)
            apply = self._apply()
            with span("solve.setup"):
                B = alphas.shape[0]
                c = (self.op.coefficients_sym(alphas) if self.sym
                     else self.op.coefficients(alphas))
                # (B, 4|7, Ny, Nx) -> (4|7, Ny, Nx, B), contiguous once a
                # solve
                coefs = c.permute(1, 2, 3, 0).contiguous()
                mask = torch.as_tensor(self.free_mask, dtype=dtype,
                                       device=device)
                bc_full = torch.zeros((B, self.Ny * self.Nx), dtype=dtype,
                                      device=device)
                bc_full[:, self._idx("con", device)] = bc_values.to(dtype)
                bc_g = self._to_blast(bc_full)
                rhs = -apply(coefs, bc_g, torch.ones_like(mask))
                precond, levels = self._precond(coefs, mask, alphas=alphas)
            y_free_g, self.iterations = _batched_pcg(
                lambda v: apply(coefs, mask * v, mask), rhs, mask, precond,
                tol, self.maxiter)
            return (self._from_blast(y_free_g + bc_g), coefs, mask, tol,
                    levels)

    def __call__(self, alphas: torch.Tensor, bc_values: torch.Tensor):
        return _Solve.apply(self, alphas, bc_values)


def make_batched_fom_solver(op: StencilOperator, profile, *, tol=None,
                            maxiter=None, precond: str = "auto",
                            precond_dtype: str | None = None,
                            sym: bool = False) -> BatchedFomSolver:
    """Build the batched differentiable solver (see
    :class:`BatchedFomSolver`).  ``precond``: 'jacobi' | 'mg' | 'auto'
    (the V-cycle on grids with both dims even, min dim >= 64 and the
    standard profile, else Jacobi, with a warning at >= 64).
    ``precond_dtype``: the V-cycle's dtype, 'bfloat16', 'float32' or
    'float64'; None is 'float32'.  An f64 solve runs the f64 V-cycle
    whatever it says, as the reference's does; the outer PCG runs in the
    data's dtype.  ``sym=True`` runs every outer stencil apply of the
    solve and its VJP in the symmetric 4-grid form (the V-cycle keeps the
    7-grid form, as in the reference)."""
    return BatchedFomSolver(op, profile, tol=tol, maxiter=maxiter,
                            precond=precond, precond_dtype=precond_dtype,
                            sym=sym)
