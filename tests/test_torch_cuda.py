"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs a CUDA card and ``nvcc``; skipped without them.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.fem import batched_solver
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_reference, apply_stencil_sym,
    apply_stencil_sym_reference)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(32, 1024), (8, 11), (5, 200)])
def test_stencil_kernel_matches_plain_version(n, B, dtype):
    _need_cuda()
    grid = fem.StructuredTriGrid(n, n)
    op = fem.StencilOperator(grid)
    g = torch.Generator().manual_seed(n * 1000 + B)
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=g,
                                   dtype=dtype)).cuda()
    coefs = op.coefficients(alphas).permute(1, 2, 3, 0).contiguous()
    v = torch.randn(n + 1, n + 1, B, generator=g, dtype=dtype).cuda()
    mask = torch.as_tensor(
        fem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1, 1),
        dtype=dtype).cuda()
    before = apply_stencil.launches
    got = apply_stencil(coefs, v, mask)
    torch.cuda.synchronize()
    assert apply_stencil.launches == before + 1
    # same products and sums in the same order, no fused multiply-adds
    assert torch.equal(got, apply_stencil_reference(coefs, v, mask))


@pytest.mark.cuda
def test_stencil_kernel_raises_on_bad_input():
    _need_cuda()
    coefs = torch.zeros(7, 5, 5, 3, device="cuda")
    v = torch.zeros(5, 5, 3, device="cuda")
    mask = torch.zeros(5, 5, 1)  # on the CPU: no silent device mix
    with pytest.raises(ValueError, match="lie on"):
        apply_stencil(coefs, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(32, 1024), (8, 11), (5, 200)])
def test_stencil_sym_kernel_matches_plain_version(n, B, dtype):
    _need_cuda()
    grid = fem.StructuredTriGrid(n, n)
    op = fem.StencilOperator(grid)
    g = torch.Generator().manual_seed(n * 1000 + B + 7)
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=g,
                                   dtype=dtype)).cuda()
    coefs4 = op.coefficients_sym(alphas).permute(1, 2, 3, 0).contiguous()
    v = torch.randn(n + 1, n + 1, B, generator=g, dtype=dtype).cuda()
    mask = torch.as_tensor(
        fem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1, 1),
        dtype=dtype).cuda()
    before = apply_stencil_sym.launches
    got = apply_stencil_sym(coefs4, v, mask)
    torch.cuda.synchronize()
    assert apply_stencil_sym.launches == before + 1
    # same products and sums in the same order, no fused multiply-adds
    assert torch.equal(got, apply_stencil_sym_reference(coefs4, v, mask))


@pytest.mark.cuda
@pytest.mark.parametrize("sym", [False, True])
def test_solve_gradients_on_the_kernels_match_the_plain_path(sym,
                                                              monkeypatch):
    """f64 solve and VJP at B=64 on the card: kernel path vs the plain
    applies, 1e-12 relative (identical applies, identical iterates)."""
    _need_cuda()
    phys = fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cuda")
    fom = phys["fom"]
    g = torch.Generator().manual_seed(3)
    alphas = torch.exp(0.5 * torch.randn(64, fom.grid.n_cells, generator=g,
                                         dtype=torch.float64)).cuda()
    vals = (torch.rand(64, fom.constrained_dofs.size, generator=g,
                       dtype=torch.float64) - 0.5).cuda()
    w = torch.randn(64, fom.dim_out, generator=g, dtype=torch.float64).cuda()

    def grads():
        solve = batched_solver.make_batched_fom_solver(fom.op, fom.profile,
                                                       sym=sym)
        a = alphas.clone().requires_grad_()
        b = vals.clone().requires_grad_()
        (w * solve(a, b)).sum().backward()
        return a.grad, b.grad

    counter = apply_stencil_sym if sym else apply_stencil
    before = counter.launches
    ga, gb = grads()
    assert counter.launches > before
    monkeypatch.setattr(batched_solver, "apply_stencil",
                        apply_stencil_reference)
    monkeypatch.setattr(batched_solver, "apply_stencil_sym",
                        apply_stencil_sym_reference)
    pa, pb = grads()
    for got, ref in ((ga, pa), (gb, pb)):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-12
