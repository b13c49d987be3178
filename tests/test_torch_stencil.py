"""The port's stencil apply (ops/stencil.py) against the JAX package's
Pallas kernel (interpret mode on the CPU) and its jnp reference.

On the CPU the port's ``apply_stencil`` runs its plain PyTorch version;
the CUDA kernel itself is held against that version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Tolerances: f32
1e-6, f64 1e-12 (same math, sums in the same order; XLA may fuse them
differently).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.ops import (
    apply_stencil as j_apply_stencil,
    apply_stencil_reference as j_apply_stencil_reference)
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_reference)

TOL = {np.float32: 1e-6, np.float64: 1e-12}


def _inputs(n, B, seed, dtype, free_mask):
    """The shapes of tests/test_ops_pallas.py: (7, Ny, Nx, B) coefficients
    of random conductivities, a random v and a free-dof or all-ones mask."""
    grid = jfem.StructuredTriGrid(n, n)
    op = jfem.StencilOperator(grid)
    rng = np.random.default_rng(seed)
    alphas = rng.uniform(0.5, 2.0, (B, grid.n_cells)).astype(dtype)
    coefs = np.moveaxis(np.asarray(op.coefficients(jnp.asarray(alphas))),
                        0, -1)
    v = rng.normal(size=(n + 1, n + 1, B)).astype(dtype)
    if free_mask:
        mask = jfem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1, 1)
    else:
        mask = np.ones((n + 1, n + 1, 1))
    return (np.ascontiguousarray(coefs), v, mask.astype(dtype))


CASES = [(8, 16, 0, True), (4, 11, 1, False), (12, 20, 2, True)]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,B,seed,free_mask", CASES)
def test_apply_stencil_matches_pallas(n, B, seed, free_mask, dtype):
    coefs, v, mask = _inputs(n, B, seed, dtype, free_mask)
    got = apply_stencil(torch.as_tensor(coefs), torch.as_tensor(v),
                        torch.as_tensor(mask)).numpy()
    assert got.dtype == dtype
    pallas = np.asarray(j_apply_stencil(jnp.asarray(coefs), jnp.asarray(v),
                                        jnp.asarray(mask), interpret=True))
    ref = np.asarray(j_apply_stencil_reference(
        jnp.asarray(coefs), jnp.asarray(v), jnp.asarray(mask)))
    np.testing.assert_allclose(got, pallas, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])


def test_cpu_path_is_the_plain_version_and_launches_nothing():
    coefs, v, mask = (torch.as_tensor(a) for a in
                      _inputs(8, 16, 0, np.float64, True))
    before = apply_stencil.launches
    got = apply_stencil(coefs, v, mask)
    assert apply_stencil.launches == before
    assert torch.equal(got, apply_stencil_reference(coefs, v, mask))


def test_apply_stencil_validates_inputs():
    coefs, v, mask = (torch.as_tensor(a) for a in
                      _inputs(4, 11, 1, np.float32, False))
    with pytest.raises(ValueError, match="coefs"):
        apply_stencil(coefs[:6], v, mask)
    with pytest.raises(ValueError, match="v must be"):
        apply_stencil(coefs, v[:, :, :5], mask)
    with pytest.raises(ValueError, match="mask must be"):
        apply_stencil(coefs, v, mask[:-1])
    with pytest.raises(TypeError, match="dtype"):
        apply_stencil(coefs, v.double(), mask)
    with pytest.raises(TypeError, match="dtype"):
        apply_stencil(coefs.half(), v.half(), mask.half())
    with pytest.raises(ValueError, match="contiguous"):
        apply_stencil(coefs, v.transpose(0, 1), mask)
