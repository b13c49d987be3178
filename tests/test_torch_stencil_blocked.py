"""The port's halo-padded symmetric stencil apply
(``apply_stencil_sym_blocked``) and its layout helpers against the JAX
package's blocked Pallas kernel (interpret mode on the CPU), mirroring
``tests/test_ops_pallas.py::test_pallas_sym_blocked_matches_reference``: a
33^2 node grid, B=140, an unmasked input, a zero output halo and a
pad/unpad round trip.  The two layouts differ (the port's is
(Ny+2, Nx+2, B), the TPU's (Bb, R, CP, 128)), so the results are compared
after ``unpad_blocked`` on each side.

On the CPU the wrapper runs its plain version; the CUDA kernel is held
against that version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.  Tolerances: f32 1e-6 against the Pallas kernel (XLA
may order the sums differently); the plain version's interior equals K2's
plain version on the masked input to 1e-12 in f64 (same sum, same order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.ops import stencil as jst
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil_sym_blocked, apply_stencil_sym_blocked_reference,
    apply_stencil_sym_reference, mask_blocked, pad_blocked,
    pad_coefs_blocked, unpad_blocked)


def _inputs(n, B, seed, dtype):
    """Symmetric coefficients (B, 4, Ny, Nx), an unmasked v (B, Ny, Nx)
    and the free-dof mask (Ny, Nx), numpy."""
    grid = tfem.StructuredTriGrid(n, n)
    rng = np.random.default_rng(seed)
    alphas = rng.uniform(0.5, 2.0, (B, grid.n_cells)).astype(dtype)
    coefs4 = tfem.StencilOperator(grid).coefficients_sym(
        torch.as_tensor(alphas)).numpy()
    v = rng.normal(size=(B, n + 1, n + 1)).astype(dtype)
    mask2 = tfem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1)
    return coefs4, v, mask2.astype(dtype), alphas


def test_blocked_apply_matches_pallas_kernel():
    n, B = 32, 140  # 33^2 nodes (odd), a second TPU batch block
    Ny = Nx = n + 1
    coefs4, v, mask2, alphas = _inputs(n, B, 3, np.float32)
    # the JAX package's own coefficients, to hold the whole path
    jc4 = np.asarray(jfem.StencilOperator(
        jfem.StructuredTriGrid(n, n)).coefficients_sym(jnp.asarray(alphas)))
    np.testing.assert_array_equal(coefs4, jc4)

    TY = jst.choose_tile_rows(Ny, Nx)
    jout = jst.apply_stencil_sym_blocked(
        jst.pad_coefs_blocked(jnp.asarray(coefs4), Ny, Nx, TY),
        jst.pad_blocked(jnp.asarray(v), Ny, Nx, TY),
        jnp.asarray(jst.mask_blocked(mask2, TY)), TY=TY, interpret=True)
    want = np.asarray(jst.unpad_blocked(jout, B, Ny, Nx))

    c_halo = pad_coefs_blocked(torch.as_tensor(coefs4), Ny, Nx)
    vb = pad_blocked(torch.as_tensor(v), Ny, Nx)  # deliberately unmasked
    mb = torch.as_tensor(mask_blocked(mask2))
    assert c_halo.shape == (4, Ny + 2, Nx + 2, B) and c_halo.is_contiguous()
    assert vb.shape == (Ny + 2, Nx + 2, B) and mb.shape == (Ny + 2, Nx + 2, 1)
    out = apply_stencil_sym_blocked(c_halo, vb, mb)
    got = unpad_blocked(out, B, Ny, Nx).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the output halo is zero, rows and columns
    for edge in (out[0], out[-1], out[:, 0], out[:, -1]):
        assert float(edge.abs().max()) == 0.0
    # pad/unpad round trip, and the padded layouts hold zero halos
    np.testing.assert_array_equal(unpad_blocked(vb, B, Ny, Nx).numpy(), v)
    for grid in (vb, c_halo[2], mb):
        assert float(grid[0].abs().max()) == 0.0
        assert float(grid[:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("n,B", [(12, 20), (5, 3)])
def test_blocked_plain_version_is_k2_on_the_masked_input(n, B):
    Ny = Nx = n + 1
    coefs4, v, mask2, _ = _inputs(n, B, n, np.float64)
    c4 = torch.as_tensor(coefs4)
    vt, mt = torch.as_tensor(v), torch.as_tensor(mask2)
    out = apply_stencil_sym_blocked_reference(
        pad_coefs_blocked(c4, Ny, Nx), pad_blocked(vt, Ny, Nx),
        torch.as_tensor(mask_blocked(mask2)))
    mask = mt[..., None]
    k2 = apply_stencil_sym_reference(c4.permute(1, 2, 3, 0).contiguous(),
                                     mask * vt.permute(1, 2, 0), mask)
    interior = out[1:1 + Ny, 1:1 + Nx]
    np.testing.assert_allclose(interior.numpy(), k2.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_blocked_wrapper_checks_its_input():
    c = torch.zeros(4, 5, 5, 3)
    v = torch.zeros(5, 5, 3)
    m = torch.zeros(5, 5, 1)
    assert apply_stencil_sym_blocked(c, v, m).shape == (5, 5, 3)
    with pytest.raises(ValueError, match="coefs must be"):
        apply_stencil_sym_blocked(torch.zeros(7, 5, 5, 3), v, m)
    with pytest.raises(ValueError, match="mask must be"):
        apply_stencil_sym_blocked(c, v, torch.zeros(5, 5, 3))
    with pytest.raises(TypeError, match="one dtype"):
        apply_stencil_sym_blocked(c, v.double(), m)
    with pytest.raises(ValueError, match="contiguous"):
        apply_stencil_sym_blocked(c, v.transpose(0, 1), m)
    with pytest.raises(ValueError, match="at least 3 x 3"):
        apply_stencil_sym_blocked(torch.zeros(4, 2, 5, 3),
                                  torch.zeros(2, 5, 3), torch.zeros(2, 5, 1))
    assert apply_stencil_sym_blocked.launches == 0  # no card: no launch
