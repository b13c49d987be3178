"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Needs a CUDA card and ``nvcc``; skipped without them.  This file
imports neither JAX nor the JAX package, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.fem import batched_solver
from generative_physics_informed_pde_tpu_torch.fem import multigrid
from generative_physics_informed_pde_tpu_torch.ops import stencil
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_reference, apply_stencil_sym,
    apply_stencil_sym_blocked, apply_stencil_sym_blocked_reference,
    apply_stencil_sym_reference, mask_blocked, pad_blocked,
    pad_coefs_blocked)
from test_torch_stencil_blocked_plan import _chip_smoke
from test_torch_stencil_blocked_plan import (
    _blocked_inputs as _cpu_blocked_inputs)

# Every padded (R, B, dtype) K3 is measured at.
K3_SHAPES = _chip_smoke().K3_SHAPES


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


def _hazard_inputs(Ny, Nx, B, dtype, n_grids, seed, hazards):
    """Seeded coefficients, v (with +0 and -0 entries) and a 0/1 mask on
    the card; with ``hazards`` the grid's edge nodes carry +-inf, -0 and
    negative coefficients."""
    rng = np.random.default_rng(seed)
    coefs = rng.standard_normal((n_grids, Ny, Nx, B))
    v = rng.standard_normal((Ny, Nx, B))
    v[rng.random(v.shape) < 0.2] = 0.0
    v[rng.random(v.shape) < 0.1] = -0.0
    mask = (rng.random((Ny, Nx, 1)) < 0.8).astype(float)
    if hazards:
        edge = np.zeros((Ny, Nx), bool)
        edge[[0, -1], :] = edge[:, [0, -1]] = True
        for k in range(n_grids):
            pick = edge[..., None] & (rng.random((Ny, Nx, B)) < 0.3)
            coefs[k][pick] = rng.choice([np.inf, -np.inf, -0.0, -2.5],
                                        size=int(pick.sum()))
    return tuple(torch.as_tensor(a, dtype=dtype, device="cuda")
                 for a in (coefs, v, mask))


def _bits(x):
    return x.view(torch.int32 if x.dtype == torch.float32 else torch.int64)


def _assert_bit_equal(kernel, plain, coefs, v, mask):
    before = kernel.launches
    got = kernel(coefs, v, mask)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(_bits(got), _bits(plain(coefs, v, mask)))


_FORMS = [(apply_stencil, apply_stencil_reference, 7),
          (apply_stencil_sym, apply_stencil_sym_reference, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Ny,Nx,B", [(13, 7, 1), (10, 23, 3), (70, 41, 257),
                                     (26, 26, 200), (1, 5, 33)])
def test_tiled_kernels_bit_equal_at_tile_edges(Ny, Nx, B, dtype, form):
    """Grids that are no multiple of the tile, batches of 1, 3 and 257
    (the scalar path) and 200 (the 16-byte path, a partial chunk)."""
    _need_cuda()
    kernel, plain, n = _FORMS[form]
    _assert_bit_equal(kernel, plain, *_hazard_inputs(Ny, Nx, B, dtype, n,
                                                     Ny * Nx + B, False))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("dtype,B", [(torch.float32, 2048),
                                     (torch.float64, 2048),
                                     (torch.float64, 256)])
def test_tiled_kernels_bit_equal_on_every_v_cycle_level(dtype, B, form):
    _need_cuda()
    kernel, plain, n = _FORMS[form]
    for nodes in (65, 33, 17, 9, 5):
        _assert_bit_equal(kernel, plain, *_hazard_inputs(
            nodes, nodes, B, dtype, n, nodes, False))


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("Ny,Nx,B", [(9, 9, 16), (33, 33, 64), (17, 12, 3)])
def test_tiled_kernels_keep_inf_nan_and_signed_zeros_at_the_edge(Ny, Nx, B,
                                                                 dtype, form):
    """+-inf, -0 and negative coefficients on the edge nodes: the zero halo
    gives inf * 0 = NaN and the signs of zero as the plain version's zero
    padding does; compared as bit patterns."""
    _need_cuda()
    kernel, plain, n = _FORMS[form]
    coefs, v, mask = _hazard_inputs(Ny, Nx, B, dtype, n, B, True)
    ref = plain(coefs, v, mask)
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    _assert_bit_equal(kernel, plain, coefs, v, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
def test_tiled_kernels_take_the_scalar_path_off_16_byte_alignment(form):
    """A contiguous view 4 bytes into its storage: the plan drops to scalar
    copies and loads, and the result is still bit-equal."""
    _need_cuda()
    kernel, plain, n = _FORMS[form]
    coefs, v, mask = _hazard_inputs(17, 17, 64, torch.float32, n, 5, False)
    store = torch.empty(v.numel() + 1, dtype=v.dtype, device="cuda")
    v_off = store[1:].view(v.shape)
    v_off.copy_(v)
    assert v_off.is_contiguous() and v_off.data_ptr() % 16 != 0
    _assert_bit_equal(kernel, plain, coefs, v_off, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("form", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_every_loaded_geometry_is_bit_equal(dtype, form, monkeypatch):
    """The geometries launch_plan gives on cards of other SM counts (other
    tile sides) and, for K2, off 16-byte alignment (scalar loads) compute
    the same bits as the plain version."""
    _need_cuda()
    kernel, plain, n = _FORMS[form]
    seen = set()
    for Ny, Nx, B in ((17, 13, 64), (33, 33, 200)):
        coefs, v, mask = _hazard_inputs(Ny, Nx, B, dtype, n, 9, True)
        store = torch.empty(v.numel() + 1, dtype=v.dtype, device="cuda")
        v_off = store[1:].view(v.shape)
        v_off.copy_(v)
        for sm in (1, 16, 132, 1024):
            monkeypatch.setattr(stencil, "_sm_count", lambda index, _s=sm: _s)
            monkeypatch.setattr(stencil, "_PLANS", {})
            for vv, aligned in ((v, True), (v_off, False)):
                seen.add(stencil.launch_plan(Ny, Nx, B, dtype, sm, bool(form),
                                             aligned))
                _assert_bit_equal(kernel, plain, coefs, vv, mask)
    # tiles of several sides (K1: 2 x 2 and 1 x 1), and for K2 both load
    # widths
    assert len({p.tile_rows for p in seen}) >= (3 if form else 2), seen
    assert {p.vec > 1 for p in seen} == ({False, True} if form else {False})


def _blocked_inputs(R, C, B, dtype, seed, hazards=False):
    """K3's inputs on the card with a zero halo (see the CPU tests'
    ``_blocked_inputs``)."""
    return _cpu_blocked_inputs(R, C, B, dtype, seed, hazards, zero_halo=True,
                               device="cuda")


def _assert_blocked_bit_equal(c, v, mask, k2=True):
    """K3 launches once, equals its plain version bit for bit, writes +0 on
    the whole output halo and (``k2``: zero-halo inputs) equals K2 on the
    masked input in the interior."""
    before = apply_stencil_sym_blocked.launches
    got = apply_stencil_sym_blocked(c, v, mask)
    torch.cuda.synchronize()
    assert apply_stencil_sym_blocked.launches == before + 1
    assert torch.equal(_bits(got),
                       _bits(apply_stencil_sym_blocked_reference(c, v, mask)))
    for edge in (got[0], got[-1], got[:, 0], got[:, -1]):
        assert not bool(_bits(edge).any())
    if k2:
        m = mask[1:-1, 1:-1].contiguous()
        want = apply_stencil_sym(c[:, 1:-1, 1:-1].contiguous(),
                                 (m * v[1:-1, 1:-1]).contiguous(), m)
        assert torch.equal(_bits(got[1:-1, 1:-1]), _bits(want))
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,C,B", [(15, 9, 1), (12, 25, 3), (72, 43, 257),
                                   (28, 28, 200), (3, 7, 33), (35, 35, 11),
                                   (35, 35, 64)])
def test_blocked_kernel_bit_equal_at_tile_edges(R, C, B, dtype):
    """Padded grids that are no multiple of the 8 x 8 tile, batches of 1,
    3, 11, 33 and 257 (the scalar path) and 64 and 200 (the 16-byte path,
    200 with a partial chunk)."""
    _need_cuda()
    _assert_blocked_bit_equal(*_blocked_inputs(R, C, B, dtype, R * C + B))


@pytest.mark.cuda
@pytest.mark.parametrize("R,B,dname", K3_SHAPES)
def test_blocked_kernel_bit_equal_at_roofline_shapes(R, B, dname):
    """Every shape K3 is measured at (``chip_smoke.K3_SHAPES``): the padded
    shapes of the JAX roofline benchmark's K3 chains and the highres32
    label shape in f32 and f64."""
    _need_cuda()
    _assert_blocked_bit_equal(*_blocked_inputs(R, R, B, getattr(torch, dname),
                                               B))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R,C,B", [(11, 11, 16), (35, 35, 64), (19, 14, 3)])
def test_blocked_kernel_keeps_inf_nan_and_signed_zeros_next_to_the_halo(
        R, C, B, dtype):
    """+-inf, -0 and negative values on the interior nodes next to the halo
    and on the halo: every term is multiplied as in the plain version, so
    inf * 0 = NaN and the signs of zero agree; compared as bit patterns."""
    _need_cuda()
    c, v, mask = _blocked_inputs(R, C, B, dtype, B, hazards=True)
    ref = apply_stencil_sym_blocked_reference(c, v, mask)
    assert bool(torch.isnan(ref).any()) and bool(torch.isinf(ref).any())
    _assert_blocked_bit_equal(c, v, mask, k2=False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocked_kernel_every_loaded_geometry_is_bit_equal(dtype,
                                                           monkeypatch):
    """The plans launch_plan gives on cards of other SM counts (other tile
    sides) and off 16-byte alignment (scalar loads)."""
    _need_cuda()
    seen = set()
    for R, C, B in ((19, 15, 64), (35, 35, 200)):
        c, v, mask = _blocked_inputs(R, C, B, dtype, 9, hazards=True)
        store = torch.empty(v.numel() + 1, dtype=v.dtype, device="cuda")
        v_off = store[1:].view(v.shape)
        v_off.copy_(v)
        assert v_off.is_contiguous() and v_off.data_ptr() % 16 != 0
        for sm in (1, 16, 132, 1024):
            monkeypatch.setattr(stencil, "_sm_count", lambda index, _s=sm: _s)
            monkeypatch.setattr(stencil, "_PLANS", {})
            for vv, aligned in ((v, True), (v_off, False)):
                seen.add(stencil.launch_plan(R, C, B, dtype, sm, True,
                                             aligned))
                _assert_blocked_bit_equal(c, vv, mask, k2=False)
    assert len({p.tile_rows for p in seen}) >= 3, seen
    assert {p.vec > 1 for p in seen} == {False, True}


@pytest.mark.cuda
def test_blocked_kernel_refused_launch_raises(monkeypatch):
    """A plan that does not fit the shape is refused by the C side, and
    the wrapper raises instead of returning an unwritten output."""
    _need_cuda()
    c, v, mask = _blocked_inputs(11, 11, 16, torch.float32, 1)
    wrong = stencil.launch_plan(13, 11, 16, torch.float32, 132, True)
    monkeypatch.setattr(stencil, "_PLANS", {})
    monkeypatch.setattr(stencil, "launch_plan", lambda *a, **k: wrong)
    before = apply_stencil_sym_blocked.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        apply_stencil_sym_blocked(c, v, mask)
    assert apply_stencil_sym_blocked.launches == before
