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
from generative_physics_informed_pde_tpu_torch.ops import stencil, vcycle
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


_VCYCLE_STEPS = ("presmooth", "restrict", "correct", "smooth", "coarse")


def _vcycle_launches():
    return sum(getattr(vcycle, f"vcycle_{s}").launches
               for s in _VCYCLE_STEPS)


def _plain_vcycle(monkeypatch):
    """The V-cycle's steps on their plain versions (on the card's
    tensors)."""
    for s in _VCYCLE_STEPS:
        monkeypatch.setattr(multigrid, f"vcycle_{s}",
                            getattr(vcycle, f"vcycle_{s}_reference"))


@pytest.mark.cuda
def test_mg_solve_on_the_kernel_matches_the_plain_path(monkeypatch):
    """f64 MG-PCG solve and VJP at 64^2, B=32: the rhs, every matvec and
    the adjoint's K lambda launch K1, every V-cycle its fused kernels
    (``launches_per_cycle`` of them, no K1); the kernel path equals the
    plain path to 1e-12."""
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

    before, vbefore = apply_stencil.launches, _vcycle_launches()
    ga, gb, solve = grads()
    per_cycle = solve.mg.launches_per_cycle
    k, kadj = solve.iterations, solve.adjoint_iterations
    # K1: the rhs and one matvec per iteration; the adjoint the same with
    # K lambda in place of the rhs.  The V-cycle: one per iteration and
    # one first, in each solve
    assert apply_stencil.launches - before == (1 + k) + (1 + kadj)
    assert _vcycle_launches() - vbefore == (k + 1 + kadj + 1) * per_cycle
    monkeypatch.setattr(batched_solver, "apply_stencil",
                        apply_stencil_reference)
    _plain_vcycle(monkeypatch)
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
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


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


def _vo_setup(device):
    from generative_physics_informed_pde_tpu_torch.constraints import (
        QuerryPointEnsemble)

    phys = fem.make_fom_rom_pair("NDP", 2, 2, 2, device=device)
    rng = np.random.default_rng(0)
    logx = rng.normal(0.2, 0.4, (5, phys["fom"].grid.n_cells))
    bce = fem.BoundaryConditionEnsemble.from_factory("NDP", 5, rng)
    bce.register_function_space("fom", phys["fom"].grid)
    qpe = QuerryPointEnsemble(
        phys["fom"], torch.as_tensor(logx, device=device),
        torch.as_tensor(bce.constrained_values("fom"), device=device))
    return phys, qpe


@pytest.mark.cuda
def test_vo_assembly_on_the_kernel_matches_the_cpu(monkeypatch):
    """Gamma (one K1 launch a test column), alpha and the effective force
    on the card equal the card's plain applies bit for bit, and the CPU's
    to rounding (exp and the coefficient sums round differently there)."""
    from generative_physics_informed_pde_tpu_torch.fem import assembly

    _need_cuda()
    (_, q_cpu), (phys, q_gpu) = _vo_setup("cpu"), _vo_setup("cuda")
    V = torch.randn(q_cpu.N, q_cpu.dim_out, 6, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    fom = phys["fom"]
    before = apply_stencil.launches
    got = (*q_gpu.construct_querry_weak_galerkin(V.cuda()),
           fom.effective_force(q_gpu.alpha, q_gpu.bc_values))
    torch.cuda.synchronize()
    assert apply_stencil.launches == before + 6 + 1 + 1
    monkeypatch.setattr(assembly, "apply_stencil", apply_stencil_reference)
    plain = (*q_gpu.construct_querry_weak_galerkin(V.cuda()),
             fom.effective_force(q_gpu.alpha, q_gpu.bc_values))
    assert apply_stencil.launches == before + 8
    cpu = (*q_cpu.construct_querry_weak_galerkin(V),
           q_cpu.physics.effective_force(q_cpu.alpha, q_cpu.bc_values))
    for a, b, c in zip(got, plain, cpu):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.cpu(), c, rtol=1e-13, atol=1e-14)


@pytest.mark.cuda
def test_vo_failure_containment_on_the_card():
    """A failed Cholesky (negative prior precision of one sample) and a
    singular energy subspace system are contained on the card, as on the
    CPU: no exception, finite moments, the other samples untouched."""
    from generative_physics_informed_pde_tpu_torch import constraints as tc

    _need_cuda()
    results = {}
    for device in ("cpu", "cuda"):
        phys, qpe = _vo_setup(device)
        vo = tc.VirtualObservablesEnsemble(
            qpe, tc.CoarseGrainedResidualSampler(W=phys["W"]),
            dtype=torch.float64)
        G = torch.zeros(qpe.N, qpe.dim_out, dtype=torch.float64,
                        device=device)
        PREC = torch.ones_like(G)
        PREC[3] = -1.0
        with pytest.warns(UserWarning, match="1/5 samples"):
            vo.update(G, PREC, 0)
        assert bool(vo._fallback_mask[3]) and int(vo._fallback_mask.sum()) == 1
        results[device] = (vo.mean.cpu(), vo.vars.cpu())

        class ZeroSampler:
            def sample_V(self, generator, n, dtype, dev):
                return torch.zeros((n, qpe.dim_out, 3), dtype=dtype,
                                   device=dev)

        ve = tc.EnergyVirtualObservablesEnsemble(qpe, 2, ZeroSampler(),
                                                 dtype=torch.float64)
        ve.update(G, torch.ones_like(G), 0)
        assert bool((ve.mean == 0).all())
    for a, b in zip(results["cuda"], results["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)


@pytest.mark.cuda
@pytest.mark.parametrize("ident,train", [("highres32", False),
                                         ("highres32", True),
                                         ("highres128", False)])
def test_bf16_codec_on_the_card_tracks_the_f32_codec(ident, train):
    """The codec with bf16 convolutions (cuDNN, TF32 off) on the card
    against the same f32 weights at full precision: outputs in f32 within
    0.05 of the output scale, the bound of the JAX package's test on the
    highres32 codec (tests/test_models.py, eval mode), here also in train
    mode, and on the deeper highres128 codec in eval mode.  The highres128
    codec in train mode (batch statistics of 16 fields, four up-sampling
    blocks) moves further than that bound; chip_smoke.py phase 9 holds the
    bf16 unlabeled term to the JAX test's ELBO bound on that test's model
    and reports the highres128 model's."""
    from generative_physics_informed_pde_tpu_torch.factories.model import (
        ModelFactory)

    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    _, model, _, enc, _ = ModelFactory.FromIdentifier(ident).setup(
        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    n = model.f.target_img_size
    z = torch.randn(16, model.dim_latent, generator=g, device="cuda")
    x = 0.4 + torch.randn(16, n, n, generator=g, device="cuda")
    out = {}
    for cd in (None, torch.bfloat16):
        m = model  # the same weights; BatchNorm state reset below
        state = {k: v.clone() for k, v in m.state_dict().items()}
        mean, logsigma = m.apply_decoder(z, train=train, compute_dtype=cd)
        head = m.apply_encoder(x, train=train, compute_dtype=cd)
        m.load_state_dict(state)
        out[cd] = [t.detach() for t in (mean, logsigma, *head)]
        assert all(t.dtype == torch.float32 for t in out[cd])
    for a, b in zip(out[torch.bfloat16], out[None]):
        assert bool(torch.isfinite(a).all())
        assert (a - b).abs().max() < 0.05 * b.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [129, 65, 5])
def test_stencil_kernel_bit_equal_at_the_128_vcycle_levels(n):
    """K1 at levels of the 128^2 f64 V-cycle (129^2 nodes down to 5^2) at
    the label dispatch's batch of 128."""
    _need_cuda()
    grid = fem.StructuredTriGrid(n - 1, n - 1)
    op = fem.StencilOperator(grid)
    g = torch.Generator().manual_seed(n)
    alphas = torch.exp(torch.randn(128, grid.n_cells, generator=g,
                                   dtype=torch.float64)).cuda()
    coefs = op.coefficients(alphas).permute(1, 2, 3, 0).contiguous()
    v = torch.randn(n, n, 128, generator=g, dtype=torch.float64).cuda()
    mask = torch.as_tensor(
        fem.DirichletProfile(grid).free_mask.reshape(n, n, 1),
        dtype=torch.float64).cuda()
    got = apply_stencil(coefs, v, mask)
    ref = apply_stencil_reference(coefs, v, mask)
    assert torch.equal(got.view(torch.int64), ref.view(torch.int64))


@pytest.mark.cuda
def test_fused_decode_equals_unfused_in_eval_on_the_card():
    """One decode over the supervised (two MC samples), unlabeled and VO
    z-samples equals the three decodes bit for bit in eval mode on the
    card (cuDNN may not pick a batch-dependent algorithm in eval)."""
    from generative_physics_informed_pde_tpu_torch.factories import highres128

    _need_cuda()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        _, model, _, _, _ = highres128(nx_rom=4, ny_rom=4, num_refines=3,
                                       dtype="float64").setup(device="cuda")
        rng = np.random.default_rng(0)
        dim_y = model.dim_y
        n_rom = model.g.rom.M.shape[0]

        def t(*shape, loc=0.0):
            return torch.as_tensor(rng.normal(loc, 0.5, shape),
                                   device="cuda")

        data = {"supervised": {"X": t(3, 32, 32, loc=0.4), "Y": t(3, dim_y),
                               "F_ROM_BC": t(3, n_rom)},
                "unsupervised": {"X": t(5, 32, 32, loc=0.4)},
                "vo": {"X": t(2, 32, 32, loc=0.4), "F_ROM_BC": t(2, n_rom)}}
        model.init_params({k: {"X": v["X"]} for k, v in data.items()
                           if k != "unsupervised"})
        model.n_mc = 2
        vo_state = (t(2, dim_y), torch.full((2, dim_y), -1.0,
                                            dtype=torch.float64,
                                            device="cuda"))
        logs = {}
        for fuse in (False, True):
            model.fuse_decodes = fuse
            gen = torch.Generator(device="cuda").manual_seed(4)
            with torch.no_grad():
                _, logs[fuse] = model.elbo(data, gen, train=False,
                                           vo_state=vo_state)
        for k, v in logs[False].items():
            assert torch.equal(torch.as_tensor(logs[True][k]),
                               torch.as_tensor(v)), k
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
def test_surrogate_bundle_saved_and_loaded_on_the_card(tmp_path):
    """A bundle exported on the card, saved and loaded there predicts bit
    for bit what the in-memory bundle predicts, at every bucket and past
    the largest; a card bundle is refused on the CPU."""
    _need_cuda()
    from generative_physics_informed_pde_tpu_torch.factories import highres32
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)

    dm = highres32().setup(device="cuda")[2]
    bundle = SurrogateBundle.build(dm, (32, 32), 25, buckets=(8, 64),
                                   device="cuda")
    path = bundle.save(str(tmp_path / "surrogate.zip"))
    loaded = SurrogateBundle.load(path, device="cuda")
    rng = np.random.default_rng(0)
    for n in (5, 8, 64, 70):
        x = rng.normal(0.4, 0.8, (n, 32, 32))
        F = rng.uniform(-0.5, 0.5, (n, 25))
        got, want = loaded.predict(x, F), bundle.predict(x, F)
        assert got.device.type == "cuda" and got.shape == want.shape
        assert torch.equal(got, want), n
    with pytest.raises(ValueError, match="device='cuda'"):
        SurrogateBundle.load(path, device="cpu")


@pytest.mark.cuda
def test_uncertainty_sweep_on_the_card_equals_the_cpu():
    """BASELINE config 5's solve and reduce
    (``examples/torch_uncertainty_study.py``) at 32^2, 4 cases x 64 f64
    fields drawn once on the CPU: the moments on the card (K1) equal the
    CPU's (plain apply) to 1e-10 relative."""
    _need_cuda()
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" \
        / "torch_uncertainty_study.py"
    spec = importlib.util.spec_from_file_location("torch_uncertainty_study",
                                                  path)
    us = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(us)
    fields = us.sample_fields(us.CORRLENGTHS, 64, n=32, dtype=torch.float64,
                              device="cpu")
    out = {}
    for device in ("cuda", "cpu"):
        phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(
            32, 32), device=device)
        bc = us.centre_bc_values(phys, fields.shape[0], torch.float64)
        before = apply_stencil.launches
        q = us.solve_qoi(phys, fields.to(device), bc)
        assert (apply_stencil.launches > before) == (device == "cuda")
        out[device] = {k: v.cpu() for k, v in us.qoi_moments(
            q, len(us.CORRLENGTHS)).items()}
    for k, v in out["cpu"].items():
        assert torch.isfinite(out["cuda"][k]).all()
        assert ((out["cuda"][k] - v).abs() / v.abs()).max() <= 1e-10, k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_single_system_solve_on_the_card_equals_the_cpu(dtype):
    """``solve_full`` (K1 at (33,33,1)) with a source and its VJP, and
    ``solve_batched_vmap`` on 16 systems (K1 at (33,33,16)), on the card
    against the CPU's plain applies: f64 to 1e-12 relative (the same
    iterates: equal PCG iteration counts, sums in another order), f32 to
    its residual floor, 1e-4."""
    _need_cuda()
    tol = 1e-12 if dtype == torch.float64 else 1e-4
    g = torch.Generator().manual_seed(14)
    out = {}
    for device in ("cuda", "cpu"):
        phys = fem.LinearEllipticPhysics("fom", "NDP",
                                         fem.StructuredTriGrid(32, 32),
                                         device=device)
        alphas = torch.exp(0.6 * torch.randn(16, phys.grid.n_cells,
                                             generator=g.manual_seed(14),
                                             dtype=dtype)).to(device)
        vals = (torch.rand(16, phys.constrained_dofs.size, generator=g,
                           dtype=dtype) - 0.5).to(device)
        f = fem.volume_force(phys.grid, torch.ones(phys.grid.n_cells,
                                                   dtype=dtype)).to(device)
        a = alphas[0].clone().requires_grad_()
        before = apply_stencil.launches
        y = phys.solve_full(a, vals[0], f)
        (ga,) = torch.autograd.grad(y.square().sum(), (a,))
        it = (phys._solver.iterations, phys._solver.adjoint_iterations)
        Y = phys.solve_batched_vmap(alphas, vals)
        launched = apply_stencil.launches - before
        assert (launched > 0) == (device == "cuda")
        out[device] = (y, ga, Y, it, phys._solver.iterations)
    card, cpu = out["cuda"], out["cpu"]
    for got, ref in zip(card[:3], cpu[:3]):
        assert ((got.cpu() - ref).abs().max() / ref.abs().max()).item() \
            <= tol
    if dtype == torch.float64:
        assert card[3] == cpu[3]
        assert torch.equal(card[4].cpu(), cpu[4])


def _card_trainer(mesh=None):
    """The highres32 recipe on the card at a small size: 24 labeled (16
    supervised, 8 validation) and 16 unlabeled fields, batch 8."""
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer, TrainerParameters)

    X = np.random.default_rng(15).normal(size=(40, 32, 32))
    p = TrainerParameters()
    p.identifier = "highres32"
    p.trainer.update(lr_init=1e-2, N_PE_interval=1)
    p.data.update(N_u=16, N_s=16, N_u_max=16, N_s_max=16, N_val=8,
                  armortized_bs=8)
    dlu = DataLoader(X[24:])
    dlu.lock_physics_assembly()
    tr = CreateTrainer(p, DataLoader(X[:24]), dlu, device="cuda")
    if mesh is not None:
        tr.setup(mesh=mesh)
    return tr


@pytest.mark.cuda
def test_one_device_mesh_step_equals_setup_on_the_card():
    """``setup(mesh=make_mesh(1))`` runs the sharded path: 3 steps equal
    ``setup()``'s bit for bit on the card (deterministic cuDNN)."""
    _need_cuda()
    from generative_physics_informed_pde_tpu_torch import parallel

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for mesh in (None, parallel.make_mesh(1, device="cuda")):
            tr = _card_trainer(mesh)
            for _ in range(3):
                tr.step()
            runs.append([t.detach().clone() for t in (
                *tr.model.parameters(), *tr.model.buffers(),
                *tr._PE.q.values(), tr.elbos())])
    finally:
        torch.backends.cudnn.deterministic = det
    assert len(runs[0]) == len(runs[1])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batchnorm_sharded_statistics_equal_the_plain_ones(dtype):
    """BatchNorm's statistics path of a sharded batch (sums over the
    processes holding it, divided by its whole count) on one process
    (k = 1) equals the plain path on the card: output, running statistics
    and input gradient, to 1e-12 (f64) / 1e-5 (f32) relative."""
    _need_cuda()
    from generative_physics_informed_pde_tpu_torch.models.codec import (
        BatchNorm, row_split)
    from generative_physics_informed_pde_tpu_torch.parallel.layout import (
        RowSplit)

    tol = 1e-12 if dtype == torch.float64 else 1e-5
    g = torch.Generator().manual_seed(16)
    x0 = torch.randn(16, 8, 9, 9, generator=g, dtype=dtype).cuda()
    out = []
    for split in (None, RowSplit(16, ((0, 16),))):
        bn = BatchNorm(8).to(device="cuda", dtype=dtype).train()
        x = x0.clone().requires_grad_()
        with row_split(split):
            y = bn(x)
        (gx,) = torch.autograd.grad(y.square().sum(), (x,))
        out.append((y.detach(), bn.running_mean, bn.running_var, gx))
    for a, b in zip(*out):
        assert ((a - b).abs().max() / b.abs().max()).item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dp", "dp_mc", "energy"])
def test_sharded_training_across_cards_equals_one_card(case, tmp_path):
    """Sharded training with one process on every card of the machine
    (nccl): ``tests/test_torch_sharded_training.py``'s ``dp`` case (a dp
    mesh of all cards), ``dp_mc`` (a (cards / 2, 2) ("dp", "mc") mesh,
    four Monte-Carlo samples) and ``energy`` (the energy-VO arm on a dp
    mesh: each card refreshes its rows of the 8 VO fields), f64, each
    process's record held to the same run in one process on the first
    card to 1e-9 of the scale.  Needs two or more cards (an even count
    for dp_mc, a divisor of 8 for energy)."""
    _need_cuda()
    import test_torch_sharded_training as sharded

    n = torch.cuda.device_count()
    if n < 2 or (case == "dp_mc" and n % 2) or (case == "energy" and 8 % n):
        pytest.skip("needs two or more cards (an even count for dp_mc, a "
                    "divisor of 8 for energy)")
    X, Xu = sharded._draw_pools()
    np.savez(tmp_path / "drawn.npz", X=X, Xu=Xu)
    pools = (X, Xu, tmp_path / "drawn.npz")
    recs = sharded._run_children(case, pools, tmp_path, world=n,
                                 device="cuda")
    ref = sharded.one_process_record(case, pools, device="cuda")
    for r, rec in enumerate(recs):
        assert str(rec.pop("backend")) == "nccl"
        sharded._assert_close(rec, ref, f"{case} card {r}")


@pytest.mark.cuda
def test_uneven_training_across_cards_equals_one_card(tmp_path):
    """``tests/test_torch_uneven_sharding.py``'s batches that do not
    divide by the shard count with one process on every card (nccl): an
    amortized unlabeled set kept whole, a minibatch of 7 over the cards
    and 3 Monte-Carlo samples of 5 labeled fields a dp block over a
    (cards / 2, 2) ("dp", "mc") mesh, f64, each process's record held to
    the same run in one process on the first card to 1e-9 of the scale.
    Needs two or four cards."""
    _need_cuda()
    import test_torch_sharded_training as sharded
    import test_torch_uneven_sharding as uneven

    n = torch.cuda.device_count()
    if n not in (2, 4):
        pytest.skip("needs two or four cards")
    X, Xu = sharded._draw_pools()
    np.savez(tmp_path / "drawn.npz", X=X, Xu=Xu)
    pools = (X, Xu, tmp_path / "drawn.npz")
    out = tmp_path / "children"
    out.mkdir()
    recs = uneven._Children(pools[2], out, device="cuda", world=n).records()
    ref = uneven.one_process_runs(pools, n, device="cuda")
    for r, rec in enumerate(recs):
        assert str(rec["backend"]) == "nccl"
        for name, (_, want) in ref.items():
            got = {k.split("/", 1)[1]: v for k, v in rec.items()
                   if k.startswith(name + "/")}
            sharded._assert_close(got, want, f"{name} card {r}")


@pytest.mark.cuda
@pytest.mark.parametrize("Ny,Nx,B", [(65, 65, 2048), (33, 33, 2048),
                                     (17, 17, 2048), (9, 9, 2048),
                                     (5, 5, 2048), (13, 7, 1), (70, 41, 257),
                                     (26, 26, 200)])
def test_k1_bf16_kernel_bit_equal_to_its_plain_version(Ny, Nx, B):
    """K1 in bf16 at the V-cycle's levels and at tile edges: loads widened
    to f32, f32 sums in the f32 kernel's order, one rounding; the plain
    version upcasts, sums and rounds the same way."""
    _need_cuda()
    _assert_bit_equal(apply_stencil, apply_stencil_reference,
                      *_hazard_inputs(Ny, Nx, B, torch.bfloat16, 7,
                                      Ny * Nx + B, False))


@pytest.mark.cuda
def test_k1_bf16_kernel_keeps_inf_and_nan_at_the_edge():
    """With +-inf, -0 and negative coefficients at the edge: equal to the
    plain version, NaN where it has NaN (a NaN's payload may differ)."""
    _need_cuda()
    coefs, v, mask = _hazard_inputs(33, 33, 64, torch.bfloat16, 7, 3, True)
    got = apply_stencil(coefs, v, mask)
    want = apply_stencil_reference(coefs, v, mask)
    nan = torch.isnan(want)
    assert bool(nan.any()) and torch.equal(torch.isnan(got), nan)
    assert torch.equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.cuda
def test_bf16_vcycle_solve_on_the_kernel(monkeypatch):
    """An f32 MG-PCG solve at 64^2, B=64, preconditioned by the bf16
    V-cycle: every V-cycle step launches its fused kernel in bf16, the
    outer matvec K1 in f32; the solve equals the plain path's and its true
    residual is within the f32 floor."""
    _need_cuda()
    phys = fem.make_fom_rom_pair("ND", 8, 8, 3, device="cuda")
    fom = phys["fom"]
    g = torch.Generator().manual_seed(9)
    alphas = torch.exp(1.3 * torch.randn(64, fom.grid.n_cells,
                                         generator=g)).cuda()
    vals = (torch.rand(64, fom.constrained_dofs.size, generator=g)
            - 0.5).cuda()
    dtypes = []
    real = stencil._launch

    def launch(name, library, coefs, v, mask, sym):
        dtypes.append(v.dtype)
        return real(name, library, coefs, v, mask, sym)

    vdtypes = []
    vreal = vcycle._launch

    def vlaunch(step, coefs, mask, r, *args, **kw):
        vdtypes.append(r.dtype)
        return vreal(step, coefs, mask, r, *args, **kw)

    monkeypatch.setattr(stencil, "_launch", launch)
    monkeypatch.setattr(vcycle, "_launch", vlaunch)
    solve = batched_solver.make_batched_fom_solver(
        fom.op, fom.profile, precond="mg", precond_dtype="bfloat16")
    Y = solve(alphas, vals)
    torch.cuda.synchronize()
    k, per_cycle = solve.iterations, solve.mg.launches_per_cycle
    assert dtypes == [torch.float32] * (1 + k)
    assert vdtypes == [torch.bfloat16] * ((k + 1) * per_cycle)
    monkeypatch.setattr(batched_solver, "apply_stencil",
                        apply_stencil_reference)
    _plain_vcycle(monkeypatch)
    plain = batched_solver.make_batched_fom_solver(
        fom.op, fom.profile, precond="mg", precond_dtype="bfloat16")
    assert torch.equal(Y, plain(alphas, vals)) and plain.iterations == k
    free = fom.free_dofs
    a64, b64 = alphas.double(), vals.double()
    f_eff = fom.effective_force(a64, b64)[:, free]
    y0 = torch.zeros(64, fom.grid.n_nodes, dtype=torch.float64,
                     device="cuda")
    y0[:, free] = Y.double()
    rel = (fom.op.matvec(a64, y0)[:, free] - f_eff).norm(dim=1) \
        / f_eff.norm(dim=1)
    assert bool((rel <= 1e-4).all()), rel.max()


@pytest.mark.cuda
def test_bundle_for_cuda_and_cpu_serves_on_both(tmp_path):
    """A ``("cuda", "cpu")`` bundle of the highres32 surrogate: the CUDA
    program equals the eager module on the card bit for bit, the CPU
    program is within 1e-5 of it (TF32 off)."""
    _need_cuda()
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres32)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dm = highres32().setup(device="cuda", generator=torch.Generator(
            ).manual_seed(0))[2]
        bundle = SurrogateBundle.build(dm, (32, 32), 25, buckets=(4, 8),
                                       device="cuda",
                                       platforms=("cuda", "cpu"))
        path = bundle.save(str(tmp_path / "s.zip"))
        on_card = SurrogateBundle.load(path, device="cuda")
        on_cpu = SurrogateBundle.load(path, device="cpu")
        assert on_card.platforms == on_cpu.platforms == ("cuda", "cpu")
        rng = np.random.default_rng(1)
        for n in (3, 8, 11):
            x = torch.as_tensor(rng.normal(0.4, 0.8, (n, 32, 32)),
                                dtype=torch.float32)
            F = torch.as_tensor(rng.uniform(-0.5, 0.5, (n, 25)),
                                dtype=torch.float32)
            eager = bundle.predict(x, F)
            assert torch.equal(on_card.predict(x, F), eager)
            cpu = on_cpu.predict(x, F)
            assert cpu.device.type == "cpu"
            err = ((cpu - eager.cpu()).abs().max()
                   / eager.abs().max()).item()
            assert err <= 1e-5, err
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def _vcycle_case(ny, nx, B, dtype, seed):
    """The V-cycle's levels of an nx x ny 'ND' grid for B lognormal fields
    on the card, with a masked r and z per level."""
    grid = fem.StructuredTriGrid(nx, ny)
    mg = multigrid.MultigridPreconditioner.for_grid(
        grid, dtype=str(dtype).removeprefix("torch."))
    g = torch.Generator(device="cuda").manual_seed(seed)
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=g,
                                   device="cuda"))
    levels = mg.setup(alphas)
    rz = [tuple((torch.randn(m.shape[0], m.shape[1], B, generator=g,
                             device="cuda") * m).to(dtype)
                for _ in range(2)) for _, m in levels]
    return mg, levels, rz


@pytest.mark.cuda
@pytest.mark.parametrize("ny,nx,B,dtype", [
    (64, 64, 16384, torch.float32), (128, 128, 128, torch.float64),
    (64, 64, 256, torch.bfloat16), (16, 32, 3, torch.float32),
    (32, 16, 257, torch.float64), (16, 32, 37, torch.bfloat16),
    (64, 64, 8, torch.float64)])
def test_vcycle_kernels_bit_equal_to_their_plain_versions(ny, nx, B, dtype):
    """Each fused step on every level it runs on (the coarse step on every
    level, the smoothing ones with each sweep count) against its plain
    version on the same tensors: equal bit for bit (bf16 too: both sum in
    f32 and round once); config 5's (65..5, 16384) f32, config 3's labels'
    (129..5, 128) f64 and the bf16 V-cycle's levels, non-square grids whose
    edge tiles are cut short, odd B, and a coarse grid whose z buffers do
    not fit shared memory ((65, 65, 8) f64)."""
    _need_cuda()
    mg, levels, rz = _vcycle_case(ny, nx, B, dtype, seed=ny + nx + B)
    w = mg.omega
    for li, ((c, m), (r, z)) in enumerate(zip(levels, rz)):
        calls = [("coarse", (c, m, r, w, mg.nu_coarse)),
                 ("smooth", (c, m, r, z, w))]
        calls += [("presmooth", (c, m, r, w, k)) for k in (0, 1, 2)]
        if li + 1 < len(levels):
            cm, ec = levels[li + 1][1], rz[li + 1][1]
            calls += [("restrict", (c, m, r, z, cm))]
            calls += [("correct", (c, m, r, z, ec, w, k)) for k in (0, 1)]
        for step, args in calls:
            kernel = getattr(vcycle, f"vcycle_{step}")
            plain = getattr(vcycle, f"vcycle_{step}_reference")
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1
            want = plain(*args)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert torch.equal(_bits(got), _bits(want)), \
                (step, li, tuple(r.shape), args[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,B,dtype", [(64, 16384, torch.float32),
                                       (128, 128, torch.float64),
                                       (512, 8, torch.float64)])
def test_vcycle_on_the_card_launches_four_a_level_and_no_k1(n, B, dtype,
                                                            monkeypatch):
    """One V-cycle on the card: 4 (L - 1) + 1 launches of the fused
    kernels, none of K1, equal to the plain V-cycle bit for bit."""
    _need_cuda()
    mg, levels, rz = _vcycle_case(n, n, B, dtype, seed=n)
    r = rz[0][0]
    k1, before = apply_stencil.launches, _vcycle_launches()
    z = mg.apply(levels, r)
    torch.cuda.synchronize()
    L = mg.num_levels
    assert _vcycle_launches() - before == mg.launches_per_cycle \
        == 4 * (L - 1) + 1
    assert apply_stencil.launches == k1
    _plain_vcycle(monkeypatch)
    assert torch.equal(_bits(z), _bits(mg.apply(levels, r)))
