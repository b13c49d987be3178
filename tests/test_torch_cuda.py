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
from generative_physics_informed_pde_tpu_torch.fem import multigrid
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_reference, apply_stencil_sym,
    apply_stencil_sym_blocked, apply_stencil_sym_blocked_reference,
    apply_stencil_sym_reference, mask_blocked, pad_blocked,
    pad_coefs_blocked)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,B", [(32, 1024), (8, 11), (32, 140)])
def test_stencil_sym_blocked_kernel_matches_plain_version(n, B, dtype):
    """Bit-equal to the plain version, zero halo, interior equal to K2 on
    the masked input."""
    _need_cuda()
    grid = fem.StructuredTriGrid(n, n)
    g = torch.Generator().manual_seed(n * 1000 + B + 13)
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=g,
                                   dtype=dtype)).cuda()
    c4 = fem.StencilOperator(grid).coefficients_sym(alphas)
    v = torch.randn(B, n + 1, n + 1, generator=g, dtype=dtype).cuda()
    mask2 = fem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1)
    c_halo = pad_coefs_blocked(c4, n + 1, n + 1)
    vb = pad_blocked(v, n + 1, n + 1)
    mb = torch.as_tensor(mask_blocked(mask2), dtype=dtype).cuda()
    before = apply_stencil_sym_blocked.launches
    got = apply_stencil_sym_blocked(c_halo, vb, mb)
    torch.cuda.synchronize()
    assert apply_stencil_sym_blocked.launches == before + 1
    assert torch.equal(got, apply_stencil_sym_blocked_reference(c_halo, vb,
                                                                mb))
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert not bool(edge.any())
    mask = mb[1:-1, 1:-1].contiguous()
    k2 = apply_stencil_sym(c4.permute(1, 2, 3, 0).contiguous(),
                           (mask * v.permute(1, 2, 0)).contiguous(), mask)
    assert torch.equal(got[1:-1, 1:-1], k2)


@pytest.mark.cuda
def test_mg_solve_on_the_kernel_matches_the_plain_path(monkeypatch):
    """f64 MG-PCG solve and VJP at 64^2, B=32: every V-cycle sweep and
    residual launches K1; the kernel path equals the plain path to 1e-12."""
    _need_cuda()
    phys = fem.make_fom_rom_pair("ND", 8, 8, 3, device="cuda")
    fom = phys["fom"]
    g = torch.Generator().manual_seed(5)
    alphas = torch.exp(0.8 * torch.randn(32, fom.grid.n_cells, generator=g,
                                         dtype=torch.float64)).cuda()
    vals = (torch.rand(32, fom.constrained_dofs.size, generator=g,
                       dtype=torch.float64) - 0.5).cuda()
    w = torch.randn(32, fom.dim_out, generator=g, dtype=torch.float64).cuda()

    def grads():
        solve = batched_solver.make_batched_fom_solver(fom.op, fom.profile)
        a = alphas.clone().requires_grad_()
        b = vals.clone().requires_grad_()
        (w * solve(a, b)).sum().backward()
        return a.grad, b.grad, solve

    before = apply_stencil.launches
    ga, gb, solve = grads()
    per_cycle = solve.mg.applies_per_cycle
    k, kadj = solve.iterations, solve.adjoint_iterations
    # rhs + per iteration one matvec and one V-cycle, plus the first
    # V-cycle; the adjoint the same with K lambda in place of the rhs
    assert apply_stencil.launches - before == \
        (1 + k + (k + 1) * per_cycle) + (1 + kadj + (kadj + 1) * per_cycle)
    monkeypatch.setattr(batched_solver, "apply_stencil",
                        apply_stencil_reference)
    monkeypatch.setattr(multigrid, "apply_stencil", apply_stencil_reference)
    pa, pb, _ = grads()
    for got, ref in ((ga, pa), (gb, pb)):
        assert ((got - ref).abs().max() / ref.abs().max()).item() <= 1e-12
