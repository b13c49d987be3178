"""The port's symmetric-form stencil apply (``apply_stencil_sym``) and
``coefficients_sym`` against the JAX package's Pallas kernel (interpret
mode on the CPU) and its jnp reference.

On the CPU the port's ``apply_stencil_sym`` runs its plain PyTorch
version; the CUDA kernel itself is held against that version on the card
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Tolerances: f32
1e-6, f64 1e-12 (same products and sums in the same order; XLA may fuse
them differently), ``coefficients_sym`` 1e-12 in f64.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.ops.stencil import (
    apply_stencil_sym as j_apply_stencil_sym,
    apply_stencil_sym_reference as j_apply_stencil_sym_reference)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_sym, apply_stencil_sym_reference)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _inputs(n, B, seed, dtype, free_mask):
    """(4, Ny, Nx, B) symmetric coefficients of random conductivities,
    a random v and a free-dof or all-ones mask (numpy)."""
    grid = jfem.StructuredTriGrid(n, n)
    op = jfem.StencilOperator(grid)
    rng = np.random.default_rng(seed)
    alphas = rng.uniform(0.5, 2.0, (B, grid.n_cells)).astype(dtype)
    coefs4 = np.moveaxis(np.asarray(op.coefficients_sym(
        jnp.asarray(alphas))), 0, -1)
    v = rng.normal(size=(n + 1, n + 1, B)).astype(dtype)
    if free_mask:
        mask = jfem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1, 1)
    else:
        mask = np.ones((n + 1, n + 1, 1))
    return np.ascontiguousarray(coefs4), v, mask.astype(dtype), alphas


CASES = [(12, 20, 0, True), (12, 11, 1, False), (5, 3, 2, True)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,B,seed,free_mask", CASES)
def test_apply_stencil_sym_matches_pallas(n, B, seed, free_mask, dtype):
    coefs4, v, mask, _ = _inputs(n, B, seed, dtype, free_mask)
    got = apply_stencil_sym(torch.as_tensor(coefs4), torch.as_tensor(v),
                            torch.as_tensor(mask)).numpy()
    assert got.dtype == dtype
    pallas = np.asarray(j_apply_stencil_sym(
        jnp.asarray(coefs4), jnp.asarray(v), jnp.asarray(mask),
        interpret=True))
    ref = np.asarray(j_apply_stencil_sym_reference(
        jnp.asarray(coefs4), jnp.asarray(v), jnp.asarray(mask)))
    np.testing.assert_allclose(got, pallas, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("n,B,seed,free_mask", CASES)
def test_sym_form_equals_the_7_grid_form(n, B, seed, free_mask):
    """K is symmetric: the 4-grid apply is the 7-grid apply."""
    coefs4, v, mask, alphas = _inputs(n, B, seed, np.float64, free_mask)
    op = tfem.StencilOperator(tfem.StructuredTriGrid(n, n))
    coefs7 = op.coefficients(torch.as_tensor(alphas)).permute(
        1, 2, 3, 0).contiguous()
    sym = apply_stencil_sym(torch.as_tensor(coefs4), torch.as_tensor(v),
                            torch.as_tensor(mask))
    full = apply_stencil(coefs7, torch.as_tensor(v), torch.as_tensor(mask))
    np.testing.assert_allclose(sym.numpy(), full.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("n", [4, 12, 33])
def test_coefficients_sym_matches_jax(n):
    grid = jfem.StructuredTriGrid(n, n)
    rng = np.random.default_rng(n)
    alphas = rng.uniform(0.5, 2.0, (3, grid.n_cells))
    ref = np.asarray(jfem.StencilOperator(grid).coefficients_sym(
        jnp.asarray(alphas)))
    got = tfem.StencilOperator(tfem.StructuredTriGrid(n, n)
                               ).coefficients_sym(torch.as_tensor(alphas))
    assert got.shape == (3, 4, n + 1, n + 1)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    # +dir couplings that leave the grid are zero (the kernel's -dir reads
    # rely on it at the top and right edges)
    assert np.all(got[:, 1, -1, :].numpy() == 0)      # c_N on the top row
    assert np.all(got[:, 2, :, -1].numpy() == 0)      # c_E on the right col
    assert np.all(got[:, 3, -1, :].numpy() == 0)      # c_D top row
    assert np.all(got[:, 3, :, -1].numpy() == 0)      # c_D right col


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    coefs4, v, mask, _ = (torch.as_tensor(a) for a in
                          _inputs(12, 20, 0, np.float64, True))
    before = apply_stencil_sym.launches
    got = apply_stencil_sym(coefs4, v, mask)
    assert apply_stencil_sym.launches == before
    assert torch.equal(got, apply_stencil_sym_reference(coefs4, v, mask))


def test_apply_stencil_sym_validates_inputs():
    coefs4, v, mask, _ = (torch.as_tensor(a) for a in
                          _inputs(5, 3, 2, np.float32, False))
    with pytest.raises(ValueError, match="coefs must be"):
        apply_stencil_sym(coefs4[:3], v, mask)
    with pytest.raises(ValueError, match="coefs must be"):
        apply_stencil_sym(torch.zeros(7, 6, 6, 3), v, mask)
    with pytest.raises(ValueError, match="v must be"):
        apply_stencil_sym(coefs4, v[:, :, :2], mask)
    with pytest.raises(ValueError, match="mask must be"):
        apply_stencil_sym(coefs4, v, mask[:-1])
    with pytest.raises(TypeError, match="dtype"):
        apply_stencil_sym(coefs4, v.double(), mask)
    with pytest.raises(TypeError, match="dtype"):
        apply_stencil_sym(coefs4.half(), v.half(), mask.half())
    with pytest.raises(ValueError, match="contiguous"):
        apply_stencil_sym(coefs4, v.transpose(0, 1), mask)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        apply_stencil_sym(coefs4.to("meta"), v.to("meta"),
                          mask.to("meta"))
