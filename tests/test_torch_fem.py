"""The port's FEM layer (grid, stencil coefficients, 'NDP' boundary
conditions, pixel conversion, interpolation W, ROM solve) against the JAX
package on the same numpy inputs.  Host-numpy pieces must agree exactly;
torch arithmetic in f64 to 1e-12."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu_torch import fem as tfem

GRIDS = [(4, 4), (8, 6), (32, 32)]


@pytest.mark.parametrize("nx,ny", GRIDS)
def test_grid_and_assembly_tables_equal(nx, ny):
    jg, tg = jfem.StructuredTriGrid(nx, ny), tfem.StructuredTriGrid(nx, ny)
    np.testing.assert_array_equal(tg.node_coords, jg.node_coords)
    np.testing.assert_array_equal(tg.cells, jg.cells)
    np.testing.assert_array_equal(tg.pixel_to_cells, jg.pixel_to_cells)
    for side in ("left", "right", "top", "bottom"):
        np.testing.assert_array_equal(tg.boundary_nodes(side),
                                      jg.boundary_nodes(side))
    np.testing.assert_array_equal(tfem.element_stiffness(tg),
                                  jfem.element_stiffness(jg))
    if tg.n_cells <= 4096:
        np.testing.assert_array_equal(tfem.assembly_tensor(tg),
                                      jfem.assembly_tensor(jg))


@pytest.mark.parametrize("nx,ny", GRIDS)
def test_stencil_coefficients_match(nx, ny):
    rng = np.random.default_rng(nx * ny)
    g = jfem.StructuredTriGrid(nx, ny)
    alphas = np.exp(rng.normal(size=(5, g.n_cells)))
    expect = np.asarray(jfem.StencilOperator(g).coefficients(
        jnp.asarray(alphas)))
    got = tfem.StencilOperator(tfem.StructuredTriGrid(nx, ny)).coefficients(
        torch.as_tensor(alphas)).numpy()
    assert got.shape == (5, 7, ny + 1, nx + 1)
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)


def test_ndp_boundary_conditions_match_bit_for_bit():
    jb = jfem.BoundaryConditionEnsemble.from_factory(
        "NDP", 16, np.random.default_rng(0))
    tb = tfem.BoundaryConditionEnsemble.from_factory(
        "NDP", 16, np.random.default_rng(0))
    np.testing.assert_array_equal(tb.thetas, jb.thetas)
    for name, (nx, ny) in (("fom", (32, 32)), ("rom", (4, 4))):
        jb.register_function_space(name, jfem.StructuredTriGrid(nx, ny))
        tb.register_function_space(name, tfem.StructuredTriGrid(nx, ny))
        np.testing.assert_array_equal(tb.constrained_dofs(name),
                                      jb.constrained_dofs(name))
        np.testing.assert_array_equal(tb.free_dofs(name), jb.free_dofs(name))
        np.testing.assert_allclose(tb.constrained_values(name),
                                   jb.constrained_values(name),
                                   rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tb.full_f_with_applied_bc("rom"),
                               jb.full_f_with_applied_bc("rom"),
                               rtol=1e-12, atol=1e-12)
    prof_j = jfem.DirichletProfile(jfem.StructuredTriGrid(32, 32))
    prof_t = tfem.DirichletProfile(tfem.StructuredTriGrid(32, 32))
    np.testing.assert_array_equal(prof_t.free_mask, prof_j.free_mask)
    np.testing.assert_allclose(
        prof_t.constrained_values(tb.thetas[:3]),
        np.asarray(prof_j.constrained_values(jnp.asarray(tb.thetas[:3]))),
        rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        tfem.BoundaryConditionEnsemble("NDP", np.zeros((3, 3)))
    with pytest.raises(NotImplementedError):
        tfem.BoundaryConditionEnsemble("XX", np.zeros((3, 4)))


def test_pixel_conversion_matches():
    rng = np.random.default_rng(3)
    img = rng.normal(size=(4, 32, 32))
    jc = jfem.PixelConverter(jfem.StructuredTriGrid(32, 32))
    tc = tfem.PixelConverter(tfem.StructuredTriGrid(32, 32))
    f_t = tc.image_to_function(torch.as_tensor(img))
    np.testing.assert_array_equal(
        f_t.numpy(), np.asarray(jc.image_to_function(jnp.asarray(img))))
    dg = rng.normal(size=(4, 2 * 32 * 32))
    np.testing.assert_allclose(
        tc.function_to_image(torch.as_tensor(dg)).numpy(),
        np.asarray(jc.function_to_image(jnp.asarray(dg))),
        rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tc.function_to_image(f_t).numpy(), img)


def test_interpolation_W_matches():
    jp = jfem.make_fom_rom_pair("NDP", 4, 4, 3)
    tp = tfem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")
    assert tp["W"].shape == (1023, 25)
    np.testing.assert_array_equal(tp["W"], jp["W"])
    np.testing.assert_array_equal(tp["fom"].free_dofs, jp["fom"].free_dofs)
    np.testing.assert_array_equal(tp["rom"].constrained_dofs,
                                  jp["rom"].constrained_dofs)
    assert tp["fom"].dim_out == jp["fom"].dim_out


def test_rom_solve_matches():
    jp = jfem.make_fom_rom_pair("NDP", 4, 4, 3)
    rom = jp["rom"]
    rng = np.random.default_rng(4)
    bce = jfem.BoundaryConditionEnsemble.from_factory("NDP", 6, rng)
    bce.register_function_space("rom", rom.grid)
    F = bce.full_f_with_applied_bc("rom")
    alpha = np.exp(rng.normal(size=(6, rom.grid.n_cells)))
    M = rom.assembly_tensor
    bc = rom.constrained_dofs
    expect = np.asarray(jfem.rom_solve(jnp.asarray(M), jnp.asarray(alpha),
                                       jnp.asarray(F), bc))
    got = tfem.rom_solve(torch.as_tensor(M), torch.as_tensor(alpha),
                         torch.tensor(F), bc).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-12, atol=1e-12)
    K_j = np.asarray(jfem.stiffness_from_tensor(
        jnp.asarray(M), jnp.asarray(alpha), jnp.asarray(bc)))
    K_t = tfem.stiffness_from_tensor(torch.as_tensor(M),
                                     torch.as_tensor(alpha), bc).numpy()
    np.testing.assert_allclose(K_t, K_j, rtol=1e-12, atol=1e-12)
