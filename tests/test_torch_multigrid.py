"""The port's multigrid V-cycle (``fem/multigrid.py``) and the batched
solver's preconditioner gate against the JAX package.

* transfers and coarsening equal to JAX's ``_prolong`` / ``_restrict`` /
  ``_coarsen_alpha_cellgrid`` (f64, 1e-14);
* level counts of ``for_grid`` as ``tests/test_multigrid.py`` pins them;
* MG-PCG solves and their gradients (``jax.grad`` of the JAX solve) with
  ``precond='mg'`` forced at 16^2 and 32^2 (f64, 1e-8: two PCGs to 1e-10
  whose sums run in other orders);
* the ``'auto'`` gate and its warnings as
  ``tests/test_multigrid.py::test_auto_precond_envelope`` holds them, the
  iteration cap under multigrid and the V-cycle's dtype.

On the CPU every V-cycle step runs its plain version (``ops/vcycle.py``:
K1's plain apply, ``_restrict``, ``_prolong``); on a card the same calls
launch the fused kernels (``tests/test_torch_cuda.py``,
``tests/test_torch_vcycle_fused.py``).
"""

import types
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.fem import multigrid as jmg
from generative_physics_informed_pde_tpu.fem.batched_solver import (
    make_batched_fom_solver as j_make_solver)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem import multigrid as tmg
from generative_physics_informed_pde_tpu_torch.fem.batched_solver import (
    make_batched_fom_solver as t_make_solver)


def test_transfers_and_coarsening_match_jax():
    rng = np.random.default_rng(0)
    e = rng.normal(size=(5, 7, 3))
    r = rng.normal(size=(9, 13, 3))
    a = np.exp(rng.normal(size=(8, 6, 2, 3)))
    for t_fn, j_fn, x in ((tmg._prolong, jmg._prolong, e),
                          (tmg._restrict, jmg._restrict, r),
                          (tmg._coarsen_alpha_cellgrid,
                           jmg._coarsen_alpha_cellgrid, a)):
        got = t_fn(torch.as_tensor(x)).numpy()
        want = np.asarray(j_fn(jnp.asarray(x)))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    # prolongation and restriction are adjoint
    lhs = (tmg._prolong(torch.as_tensor(e)) * torch.as_tensor(r)).sum()
    rhs = (torch.as_tensor(e) * tmg._restrict(torch.as_tensor(r))).sum()
    np.testing.assert_allclose(lhs.item(), rhs.item(), rtol=1e-12)


@pytest.mark.parametrize("nx,ny,levels", [
    (64, 64, 5), (4, 4, 1), (96, 96, 5), (128, 64, 5), (100, 100, 3)])
def test_level_counts_match_jax(nx, ny, levels):
    t = tmg.MultigridPreconditioner.for_grid(tfem.StructuredTriGrid(nx, ny))
    j = jmg.MultigridPreconditioner.for_grid(jfem.StructuredTriGrid(nx, ny))
    assert t.num_levels == j.num_levels == levels
    # the V-cycle's launches on a card: four a level and one coarsest
    assert t.launches_per_cycle == (levels - 1) * 4 + 1


@pytest.mark.parametrize("n", [16, 32])
def test_mg_solve_and_gradients_match_jax(n):
    B = 3
    jphys = jfem.LinearEllipticPhysics("fom", "ND",
                                       jfem.StructuredTriGrid(n, n))
    tphys = tfem.LinearEllipticPhysics("fom", "ND",
                                       tfem.StructuredTriGrid(n, n),
                                       device="cpu")
    rng = np.random.default_rng(n)
    alphas = np.exp(rng.normal(0, 0.8, (B, jphys.grid.n_cells)))
    theta = rng.uniform(-0.5, 0.5, (B, 4))
    vals = np.array(jphys.profile.constrained_values(jnp.asarray(theta)))
    w = rng.normal(size=(B, jphys.dim_out))

    jsolve = j_make_solver(jphys.op, jphys.profile, precond="mg")

    def loss(a, b):
        y = jsolve(a, b)
        return jnp.sum(jnp.asarray(w) * y), y

    (_, yj), (gaj, gbj) = jax.jit(jax.value_and_grad(
        loss, (0, 1), has_aux=True))(jnp.asarray(alphas), jnp.asarray(vals))
    tsolve = t_make_solver(tphys.op, tphys.profile, precond="mg")
    assert tsolve.mg is not None and tsolve.maxiter == 60
    a = torch.as_tensor(alphas).requires_grad_()
    b = torch.as_tensor(vals).requires_grad_()
    y = tsolve(a, b)
    (torch.as_tensor(w) * y).sum().backward()
    assert 0 < tsolve.iterations < 60 and 0 < tsolve.adjoint_iterations < 60
    np.testing.assert_allclose(
        y.detach().numpy(), np.asarray(yj), rtol=1e-8,
        atol=1e-8 * np.abs(y.detach().numpy()).max())
    for got, want in ((a.grad, gaj), (b.grad, gbj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-8,
                                   atol=1e-8 * np.abs(want).max())


def test_auto_gate_and_its_warnings():
    """As the JAX test: even grids >= 64 get the V-cycle silently; an odd
    dim at >= 64 falls back to Jacobi with a warning; small odd grids stay
    silent; a non-standard profile warns under 'auto' and raises under
    'mg'."""
    phys = tfem.LinearEllipticPhysics("fom", "NDP",
                                      tfem.StructuredTriGrid(96, 96),
                                      device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        solve = t_make_solver(phys.op, phys.profile, precond="auto")
    assert solve.mg is not None and solve.mg.num_levels == 5
    rng = np.random.default_rng(3)
    alphas = torch.as_tensor(np.exp(rng.normal(0, 0.8, (2, phys.grid.n_cells))),
                             dtype=torch.float32)
    vals = torch.as_tensor(phys.profile.constrained_values(
        rng.uniform(-0.5, 0.5, (2, 4))), dtype=torch.float32)
    Y = solve(alphas, vals)
    # against an f64 Jacobi-PCG solve (a dense direct solve at 96^2 would
    # hold a 0.7 GB matrix)
    y0 = t_make_solver(phys.op, phys.profile, precond="jacobi")(
        alphas.double(), vals.double())
    np.testing.assert_allclose(Y.numpy(), y0.numpy(), rtol=5e-3, atol=1e-6)

    odd = tfem.LinearEllipticPhysics("fom", "NDP",
                                     tfem.StructuredTriGrid(65, 64),
                                     device="cpu")
    with pytest.warns(UserWarning, match="odd grid dimension"):
        s = t_make_solver(odd.op, odd.profile, precond="auto")
    assert s.mg is None
    small = tfem.LinearEllipticPhysics("fom", "NDP",
                                       tfem.StructuredTriGrid(17, 16),
                                       device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert t_make_solver(small.op, small.profile).mg is None
    g64 = tfem.StructuredTriGrid(64, 64)
    std = tfem.DirichletProfile(g64)
    mask = std.free_mask.copy()
    mask.reshape(65, 65)[0] = 0.0  # the bottom row constrained as well
    custom = types.SimpleNamespace(
        free_mask=mask, free_dofs=np.flatnonzero(mask),
        constrained_dofs=np.flatnonzero(mask == 0))
    with pytest.warns(UserWarning, match="non-standard constraint"):
        assert t_make_solver(tfem.StencilOperator(g64), custom).mg is None
    with pytest.raises(ValueError, match="standard left/right"):
        t_make_solver(tfem.StencilOperator(g64), custom, precond="mg")


def test_vcycle_dtype():
    """float32 V-cycle by default (the reference's default off a TPU); an
    f64 solve runs the f64 V-cycle; the Jacobi path keeps no levels."""
    grid = tfem.StructuredTriGrid(16, 16)
    op, prof = tfem.StencilOperator(grid), tfem.DirichletProfile(grid)
    solve = t_make_solver(op, prof, precond="mg")
    assert solve.mg.dtype == "float32" and solve.mg.num_levels == 3
    alphas = torch.ones(2, grid.n_cells, dtype=torch.float64)
    coefs = op.coefficients(alphas).permute(1, 2, 3, 0).contiguous()
    mask = torch.as_tensor(prof.free_mask.reshape(17, 17, 1))
    _, levels = solve._precond(coefs, mask, alphas=alphas)
    assert [lv[0].dtype for lv in levels] == [torch.float64] * 3
    _, levels = solve._precond(coefs.float(), mask.float(),
                               alphas=alphas.float())
    assert [lv[0].dtype for lv in levels] == [torch.float32] * 3
    _, levels = t_make_solver(op, prof, precond="jacobi")._precond(
        coefs, mask)
    assert levels is None
