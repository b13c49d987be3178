"""The port's batched label solve (fem/batched_solver.py, through the
stencil apply) against the JAX package's ``solve_batched`` and its dense
``solve_direct`` on the highres32 geometry (32^2 FOM, 'NDP'), B=8, f64:
rtol 1e-8 (both PCGs stop at a 1e-10 relative residual)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem import batched_solver


@pytest.fixture(scope="module")
def problem():
    jp = jfem.make_fom_rom_pair("NDP", 4, 4, 3)
    tp = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    rng = np.random.default_rng(0)
    B = 8
    X = rng.normal(0.4, 0.8, size=(B, 32, 32))
    bce = jfem.BoundaryConditionEnsemble.from_factory("NDP", B, rng)
    bce.register_function_space("fom", jp["fom"].grid)
    alphas = np.exp(np.asarray(jp["fom"].pixels.image_to_function(
        jnp.asarray(X))))
    vals = bce.constrained_values("fom")
    return jp, tp, alphas, vals


def test_batched_solve_matches_jax_f64(problem):
    jp, tp, alphas, vals = problem
    expect = np.asarray(jp["fom"].solve_batched(jnp.asarray(alphas),
                                                jnp.asarray(vals)))
    got = tp["fom"].solve_batched(torch.as_tensor(alphas),
                                  torch.as_tensor(vals)).numpy()
    assert got.shape == (8, 1023) and got.dtype == np.float64
    np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-8)
    for i in (0, 5):
        direct = jp["fom"].solve_direct(alphas[i], vals[i])
        np.testing.assert_allclose(got[i], direct, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(
            tp["fom"].solve_direct(alphas[i], vals[i]), direct,
            rtol=1e-12, atol=1e-12)
    its = tp["fom"].last_iterations
    assert 0 < its < tp["fom"]._batched_solver.maxiter


def test_batched_solve_f32_agrees_with_direct(problem):
    """The f32 solve (tol 2e-6, as on the card) against the f64 direct
    oracle: f32 rounding leaves ~1e-5 relative error, bound 1e-4."""
    jp, tp, alphas, vals = problem
    got = tp["fom"].solve_batched(torch.as_tensor(alphas, dtype=torch.float32),
                                  torch.as_tensor(vals, dtype=torch.float32))
    assert got.dtype == torch.float32
    direct = np.stack([jp["fom"].solve_direct(a, v)
                       for a, v in zip(alphas, vals)])
    err = np.linalg.norm(got.numpy() - direct, axis=1) \
        / np.linalg.norm(direct, axis=1)
    assert err.max() < 1e-4


def test_pcg_runs_until_every_sample_converged():
    """A sample with a zero rhs converges at once, yet iterations continue
    for the others (the reference's any() condition); alpha's 0/0 guard
    keeps the zero sample at exactly zero."""
    tp = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    fom = tp["fom"]
    rng = np.random.default_rng(1)
    alphas = torch.as_tensor(np.exp(rng.normal(size=(3, fom.grid.n_cells))))
    vals = torch.as_tensor(rng.uniform(-.5, .5, (3, len(fom.constrained_dofs))))
    vals[1] = 0.0
    y = fom.solve_batched(alphas, vals)
    assert fom.last_iterations > 1
    assert torch.all(y[1] == 0)
    direct = fom.solve_direct(alphas[0].numpy(), vals[0].numpy())
    np.testing.assert_allclose(y[0].numpy(), direct, rtol=1e-8, atol=1e-8)


def test_solver_options_and_devices():
    tp = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    fom = tp["fom"]
    with pytest.raises(ValueError):
        batched_solver.make_batched_fom_solver(fom.op, fom.profile,
                                               precond="ilu")
    # multigrid forced at 32^2: 4 levels, 60 iterations at most
    mg = batched_solver.make_batched_fom_solver(fom.op, fom.profile,
                                                precond="mg")
    assert mg.mg.num_levels == 4 and mg.maxiter == 60
    big = tfem.make_fom_rom_pair("NDP", 8, 8, 3, device="cpu")["fom"]
    # 'auto' at 64^2 picks the V-cycle, as the physics' own solver does
    assert batched_solver.make_batched_fom_solver(
        big.op, big.profile).mg.num_levels == 5
    assert big._batched_solver.mg is not None and fom._batched_solver.mg \
        is None
    assert batched_solver.make_batched_fom_solver(
        big.op, big.profile, precond="jacobi").maxiter == 30 * 64
    assert fom._batched_solver.maxiter == 960
    with pytest.raises(ValueError, match="expected"):
        fom.solve_batched(torch.ones(2, fom.grid.n_cells, device="meta"),
                          torch.zeros(2, len(fom.constrained_dofs)))
