"""The port's differentiable batched solve (``fem/batched_solver.py``, a
``torch.autograd.Function``) against the JAX package's
``make_batched_fom_solver`` and its custom VJP, in both stencil forms
(``sym=False``: the 7-grid apply K1; ``sym=True``: the 4-grid apply K2),
on the highres32 geometry (4^2 ROM refined 3 times: 32^2), B=8, f64.

Tolerances: forward and gradients 1e-8 relative to the largest entry (the
two packages run the same PCG to the same 1e-10 tolerance, with sums in
another order, so the iterates differ by rounding only);
``cell_bilinear`` 1e-12; the mixed f32/f64 call 1e-4 (an f32 solve).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.fem.batched_solver import (
    make_batched_fom_solver as j_make_solver)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem.batched_solver import (
    make_batched_fom_solver)
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_sym)

B = 8


@pytest.fixture(scope="module")
def problem():
    jphys = jfem.make_fom_rom_pair("NDP", 4, 4, 3)
    tphys = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    fom = jphys["fom"]
    rng = np.random.default_rng(5)
    alphas = np.exp(0.6 * rng.normal(size=(B, fom.grid.n_cells)))
    bce = jfem.BoundaryConditionEnsemble.from_factory(
        "NDP", B, np.random.default_rng(6))
    bce.register_function_space("fom", fom.grid)
    vals = np.asarray(bce.constrained_values("fom"))
    w = rng.normal(size=(B, fom.dim_out))
    return jphys, tphys, alphas, vals, w


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_value_and_grads(jphys, sym, alphas, vals, w):
    fom = jphys["fom"]
    solve = j_make_solver(fom.op, fom.profile, sym=sym)

    def loss(a, b):
        return jnp.sum(jnp.asarray(w) * solve(a, b))

    Y = solve(jnp.asarray(alphas), jnp.asarray(vals))
    ga, gb = jax.grad(loss, argnums=(0, 1))(jnp.asarray(alphas),
                                            jnp.asarray(vals))
    return np.asarray(Y), np.asarray(ga), np.asarray(gb)


def _port_value_and_grads(tphys, sym, alphas, vals, w, dtypes=None):
    fom = tphys["fom"]
    solve = make_batched_fom_solver(fom.op, fom.profile, sym=sym)
    da, db = dtypes or (torch.float64, torch.float64)
    a = torch.tensor(alphas, dtype=da, requires_grad=True)
    b = torch.tensor(vals, dtype=db, requires_grad=True)
    Y = solve(a, b)
    (torch.as_tensor(w, dtype=Y.dtype) * Y).sum().backward()
    return Y.detach(), a.grad, b.grad, solve


@pytest.mark.parametrize("sym", [False, True])
def test_forward_and_gradients_match_jax(problem, sym):
    jphys, tphys, alphas, vals, w = problem
    Yj, gaj, gbj = _jax_value_and_grads(jphys, sym, alphas, vals, w)
    Y, ga, gb, solve = _port_value_and_grads(tphys, sym, alphas, vals, w)
    assert solve.iterations > 0 and solve.adjoint_iterations > 0
    assert _rel(Y.numpy(), Yj) <= 1e-8
    assert _rel(ga.numpy(), gaj) <= 1e-8
    assert _rel(gb.numpy(), gbj) <= 1e-8


@pytest.mark.parametrize("sym", [False, True])
def test_every_stencil_apply_goes_through_its_wrapper(problem, sym,
                                                      monkeypatch):
    """The solve, its rhs and its adjoint call the wrapper of their form
    (K2 with sym=True, K1 otherwise) once per apply: 1 + iterations in
    the forward, adjoint iterations + 1 in the backward."""
    from generative_physics_informed_pde_tpu_torch.fem import batched_solver
    _, tphys, alphas, vals, w = problem
    calls = {"k1": 0, "k2": 0}

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(batched_solver, "apply_stencil",
                        count("k1", apply_stencil))
    monkeypatch.setattr(batched_solver, "apply_stencil_sym",
                        count("k2", apply_stencil_sym))
    fom = tphys["fom"]
    solve = make_batched_fom_solver(fom.op, fom.profile, sym=sym)
    a = torch.tensor(alphas, requires_grad=True)
    Y = solve(a, torch.tensor(vals))
    used, other = ("k2", "k1") if sym else ("k1", "k2")
    assert calls[used] == solve.iterations + 1 and calls[other] == 0
    (torch.as_tensor(w) * Y).sum().backward()
    assert calls[used] == solve.iterations + solve.adjoint_iterations + 2
    assert calls[other] == 0


def test_sym_and_full_forms_agree(problem):
    _, tphys, alphas, vals, w = problem
    _, ga7, gb7, _ = _port_value_and_grads(tphys, False, alphas, vals, w)
    _, ga4, gb4, _ = _port_value_and_grads(tphys, True, alphas, vals, w)
    assert _rel(ga4.numpy(), ga7.numpy()) <= 1e-8
    assert _rel(gb4.numpy(), gb7.numpy()) <= 1e-8


def test_cell_bilinear_matches_jax():
    grid = jfem.StructuredTriGrid(6, 5)
    rng = np.random.default_rng(3)
    u = rng.normal(size=(4, grid.n_nodes))
    v = rng.normal(size=(4, grid.n_nodes))
    ref = np.asarray(jfem.StencilOperator(grid).cell_bilinear(
        jnp.asarray(u), jnp.asarray(v)))
    got = tfem.StencilOperator(tfem.StructuredTriGrid(6, 5)).cell_bilinear(
        torch.as_tensor(u), torch.as_tensor(v))
    assert got.shape == (4, grid.n_cells)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("sym", [False, True])
def test_mixed_dtype_cotangents_carry_the_primal_dtypes(problem, sym):
    jphys, tphys, alphas, vals, w = problem
    Y, ga, gb, _ = _port_value_and_grads(
        tphys, sym, alphas, vals, w, dtypes=(torch.float32, torch.float64))
    assert Y.dtype == torch.float32
    assert ga.dtype == torch.float32 and gb.dtype == torch.float64
    _, gaj, gbj = _jax_value_and_grads(jphys, sym, alphas, vals, w)
    assert _rel(ga.numpy(), gaj) <= 1e-4
    assert _rel(gb.numpy(), gbj) <= 1e-4


def test_physics_solve_batched_is_differentiable(problem):
    jphys, tphys, alphas, vals, w = problem
    _, gaj, _ = _jax_value_and_grads(jphys, False, alphas, vals, w)
    a = torch.tensor(alphas, requires_grad=True)
    Y = tphys["fom"].solve_batched(a, torch.tensor(vals))
    (torch.as_tensor(w) * Y).sum().backward()
    assert _rel(a.grad.numpy(), gaj) <= 1e-8
