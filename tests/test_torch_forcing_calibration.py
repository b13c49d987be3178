"""The port's force vectors and ROM calibration against the JAX package's.

``fem.volume_force`` / ``neumann_force`` (and the spacing-keyed edge
cache), ``solve_full`` with a source and a Neumann flux, and
``models.calibration`` (``optimize_effective_properties``,
``reduced_order_model_solve``), on the same seeded numpy inputs, f64.

Tolerances: the force vectors 1e-14 relative (the same sums); the forced
solve against a dense f64 solve 1e-9 (PCG to 1e-10); the calibration's
``logX`` 1e-8 and its objective 1e-10 relative after 50 Adam steps from
the same zero start (``torch.optim.Adam`` and ``optax.adam`` round the
same update differently); the Galerkin oracle 1e-12.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.models import (
    ReducedOrderModelOperator as JROM)
from generative_physics_informed_pde_tpu.models import (
    calibration as jcal)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem.assembly import (
    dense_stiffness)
from generative_physics_informed_pde_tpu_torch.models import (
    ReducedOrderModelOperator, optimize_effective_properties,
    reduced_order_model_solve)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: many small ops, which slow down by tens of
    times when the test workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("side", ["left", "right", "top", "bottom"])
def test_force_vectors_match_jax(side):
    jg, tg = jfem.StructuredTriGrid(6, 4, 1.5, 1.0), \
        tfem.StructuredTriGrid(6, 4, 1.5, 1.0)
    rng = np.random.default_rng(3)
    f_cells = rng.normal(size=(3, tg.n_cells))
    assert _rel(tfem.volume_force(tg, torch.as_tensor(f_cells)),
                jfem.volume_force(jg, jnp.asarray(f_cells))) <= 1e-14
    n_edges = len(tg.boundary_nodes(side)) - 1
    g = rng.normal(size=(2, n_edges))
    got = tfem.neumann_force(tg, side, torch.as_tensor(g))
    assert got.shape == (2, tg.n_nodes)
    assert _rel(got, jfem.neumann_force(jg, side, jnp.asarray(g))) <= 1e-14


def test_neumann_force_cache_not_shared_across_domain_sizes():
    """The side-edge cache keys on the grid spacing: two grids of one
    resolution over different domains load their own lengths (after
    tests/test_fem_assembly.py:194)."""
    g1 = tfem.StructuredTriGrid(4, 4, 1.0, 1.0)
    g2 = tfem.StructuredTriGrid(4, 4, 2.0, 2.0)
    s1 = float(tfem.neumann_force(g1, "left", torch.ones(g1.ny)).sum())
    s2 = float(tfem.neumann_force(g2, "left", torch.ones(g2.ny)).sum())
    np.testing.assert_allclose(s1, 1.0, rtol=1e-12)
    np.testing.assert_allclose(s2, 2.0, rtol=1e-12)


def test_forced_solve_against_dense():
    """A DG0 source plus a flux on the top side (both families leave top
    and bottom free) through ``solve_full``, against the dense f64 solve
    of the same load."""
    phys = tfem.LinearEllipticPhysics("fom", "NDP",
                                      tfem.StructuredTriGrid(16, 16),
                                      device="cpu")
    grid = phys.grid
    rng = np.random.default_rng(4)
    alpha = np.exp(0.5 * rng.normal(size=grid.n_cells))
    vals = phys.profile.constrained_values(rng.normal(size=4))
    src = rng.normal(size=grid.n_cells)
    flux = rng.normal(size=len(grid.boundary_nodes("top")) - 1)
    f = (tfem.volume_force(grid, torch.as_tensor(src))
         + tfem.neumann_force(grid, "top", torch.as_tensor(flux)))
    y = phys.solve_full(torch.as_tensor(alpha), torch.as_tensor(vals), f)
    K = dense_stiffness(grid, alpha)
    free, con = phys.free_dofs, phys.constrained_dofs
    want = np.zeros(grid.n_nodes)
    want[con] = vals
    want[free] = np.linalg.solve(K[np.ix_(free, free)],
                                 f.numpy()[free] - K[np.ix_(free, con)] @ vals)
    assert _rel(y, want) <= 1e-9


@pytest.fixture(scope="module")
def calibration_problem():
    """tests/test_aux_components.py:59's problem: 'NDP' 2^2 ROM refined
    twice, 4 samples of a known logX."""
    jphys = jfem.make_fom_rom_pair("NDP", 2, 2, 2)
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    jg = JROM.from_physics(jphys)
    tg = ReducedOrderModelOperator.from_physics(tphys).double()
    rng = np.random.default_rng(0)
    logX_true = rng.normal(0, 0.2, (4, jg.dim_effective_property))
    bce = jfem.BoundaryConditionEnsemble.from_factory("NDP", 4, rng)
    bce.register_function_space("rom", jphys["rom"].grid)
    F = np.asarray(bce.full_f_with_applied_bc("rom"))
    Y = np.asarray(jg.forward_mean(jnp.asarray(logX_true), jnp.asarray(F)))
    return jg, tg, Y, F, tphys


def test_optimize_effective_properties_matches_jax(calibration_problem):
    jg, tg, Y, F, _ = calibration_problem
    jlx, jY, jobj = jcal.optimize_effective_properties(
        jg, jg.init_params(jnp.float64), jnp.asarray(Y), jnp.asarray(F),
        num_iterations=50, lr=5e-2)
    tlx, tY, tobj = optimize_effective_properties(
        tg, torch.as_tensor(Y), torch.as_tensor(F), num_iterations=50,
        lr=5e-2)
    assert len(tobj) == 50 and tobj[-1] < tobj[0]
    assert _rel(tlx, jlx) <= 1e-8
    assert _rel(tobj, jobj) <= 1e-10
    assert _rel(tY, jY) <= 1e-8


def test_optimize_effective_properties_fits(calibration_problem):
    """The JAX test's own fit check (tests/test_aux_components.py:59)."""
    _, tg, Y, F, _ = calibration_problem
    Yt = torch.as_tensor(Y)
    logX, Y_pred, obj = optimize_effective_properties(
        tg, Yt, torch.as_tensor(F), num_iterations=400, lr=5e-2)
    assert obj[-1] < 1e-2 * obj[0]
    assert float((Y_pred - Yt).norm() / Yt.norm()) < 0.05


def test_reduced_order_model_solve_matches_jax():
    jphys = jfem.make_fom_rom_pair("NDP", 2, 2, 1)
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 1, device="cpu")
    fom = tphys["fom"]
    rng = np.random.default_rng(1)
    X_DG = rng.normal(0, 0.3, (2, fom.grid.n_cells))
    bce = tfem.BoundaryConditionEnsemble.from_factory("NDP", 2, rng)
    bce.register_function_space("fom", fom.grid)
    vals = bce.constrained_values("fom")
    got = reduced_order_model_solve(fom, tphys["W"], X_DG, vals)
    want = jcal.reduced_order_model_solve(jphys["fom"], jphys["W"], X_DG,
                                          vals)
    assert got.shape == (2, fom.dim_out)
    assert _rel(got, want) <= 1e-12
    Y_fine = np.stack([fom.solve_direct(np.exp(X_DG[n]), vals[n])
                       for n in range(2)])
    assert np.linalg.norm(got - Y_fine) / np.linalg.norm(Y_fine) < 0.5
