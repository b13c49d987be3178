"""The V-cycle's dtype (``precond_dtype``) and K1 in bfloat16, against the
JAX package.

* An f64 solve preconditions with the f64 V-cycle in both packages (the
  JAX package's ``_mg_for_dtype``): the V-cycle each solve builds, applied
  to one f64 residual, agrees to 1e-12 of the max at 32^2 and 64^2 (the
  f32 V-cycle would differ by ~1e-7).  The f64 MG solve and its VJP equal
  the dense direct solve and its dense adjoint to 1e-8.
* ``precond_dtype``: None resolves to float32 for every data dtype, as the
  JAX package resolves it off a TPU; 'bfloat16', 'float32' and 'float64'
  are taken, anything else refused.
* K1's plain bf16 apply (inputs upcast, f32 sums, one rounding) against
  the JAX package's Pallas kernel (interpret mode) and its XLA apply on the
  same bf16 inputs, which round at every step: within 2 bf16 ulps of the
  max (2^-6; measured 5.3e-3), and within half an ulp of the exact sum.
* The bf16 V-cycle: the levels' coefficients and masks bit-equal to the
  JAX package's (the port stores no inverse diagonal), one apply within 4
  bf16 ulps of the max (2^-5; measured 9.7e-3: the JAX package rounds at
  every step, the port's fused steps once an output), every step of it in
  bf16 and the outer matvec in f32.
* A bf16-preconditioned f32 solve of high-contrast fields (lognormal
  sigma = 1.3, the JAX test's case at 32^2): true residual < 10 tol and
  the solution within 1e-4 of the JAX package's (measured 4.5e-6).

On a card K1's bf16 kernel and the V-cycle's bf16 kernels are held to
their plain versions bit for bit by ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.fem import multigrid as jmg
from generative_physics_informed_pde_tpu.fem.batched_solver import (
    _apply_stencil_blast as j_blast, make_batched_fom_solver as j_make_solver)
from generative_physics_informed_pde_tpu.ops import (
    apply_stencil as j_apply_stencil)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch.fem import multigrid as tmg
from generative_physics_informed_pde_tpu_torch.fem.batched_solver import (
    _apply_stencil_blast, make_batched_fom_solver as t_make_solver)
from generative_physics_informed_pde_tpu_torch.ops import (
    apply_stencil, apply_stencil_sym, apply_stencil_sym_blocked)
from generative_physics_informed_pde_tpu_torch.ops.stencil import launch_plan

BF16_ULP = 2.0 ** -7           # the spacing of bf16 numbers in [1, 2)
APPLY_RTOL = 2 * BF16_ULP      # port vs the JAX package's bf16 applies
VCYCLE_RTOL = 4 * BF16_ULP     # port vs the JAX package's bf16 V-cycle
SOLVE_RTOL = 1e-4              # bf16-preconditioned f32 solves
F64_VCYCLE_RTOL = 1e-12
DIRECT_RTOL = 1e-8


def _physics(n, family="ND"):
    return (jfem.LinearEllipticPhysics("fom", family,
                                       jfem.StructuredTriGrid(n, n)),
            tfem.LinearEllipticPhysics("fom", family,
                                       tfem.StructuredTriGrid(n, n),
                                       device="cpu"))


def _fields(phys, B, sigma, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    alphas = np.exp(rng.normal(0, sigma, (B, phys.grid.n_cells)))
    theta = np.tile([[0.0, 0.0, 1.0, 1.0]], (B, 1))
    vals = np.asarray(phys.profile.constrained_values(jnp.asarray(theta)))
    return alphas.astype(dtype), vals.astype(dtype), rng


def _spy(monkeypatch, cls):
    """Record the preconditioner object of every ``apply`` call."""
    seen = []
    real = cls.apply

    def apply(self, levels, r):
        seen.append(self)
        return real(self, levels, r)

    monkeypatch.setattr(cls, "apply", apply)
    return seen


@pytest.mark.parametrize("n", [32, 64])
def test_vcycle_inside_an_f64_solve_matches_jax(n, monkeypatch):
    jphys, tphys = _physics(n)
    alphas, vals, rng = _fields(jphys, 4, 1.0, n)
    j_seen = _spy(monkeypatch, jmg.MultigridPreconditioner)
    t_seen = _spy(monkeypatch, tmg.MultigridPreconditioner)
    # tracing the JAX solve is enough to see which V-cycle it runs
    jax.make_jaxpr(j_make_solver(jphys.op, jphys.profile, precond="mg"))(
        jnp.asarray(alphas), jnp.asarray(vals))
    t_make_solver(tphys.op, tphys.profile, precond="mg")(
        torch.as_tensor(alphas), torch.as_tensor(vals))
    assert j_seen and t_seen
    assert {m.dtype for m in j_seen} == {m.dtype for m in t_seen} \
        == {"float64"}
    jm, tm = j_seen[0], t_seen[0]
    mask = tphys.profile.free_mask.reshape(n + 1, n + 1, 1)
    r = rng.normal(size=(n + 1, n + 1, 4)) * mask
    zj = np.asarray(jax.jit(lambda a, r: jm.apply(jm.setup(a), r))(
        jnp.asarray(alphas), jnp.asarray(r)))
    zt = tm.apply(tm.setup(torch.as_tensor(alphas)),
                  torch.as_tensor(r)).numpy()
    assert zt.dtype == np.float64
    np.testing.assert_allclose(zt, zj, rtol=0,
                               atol=F64_VCYCLE_RTOL * np.abs(zj).max())


def test_f64_mg_solve_and_vjp_match_the_dense_direct_solve():
    """At 32^2 with precond='mg': the labels against ``solve_direct``, the
    alpha gradient of w . y against the dense adjoint (lambda = K_ff^-1 w
    by a dense solve, contracted with y cell by cell)."""
    _, tphys = _physics(32)
    alphas, vals, rng = _fields(tphys, 2, 0.8, 5)
    w = rng.normal(size=(2, tphys.dim_out))
    solve = t_make_solver(tphys.op, tphys.profile, precond="mg")
    a = torch.as_tensor(alphas).requires_grad_()
    y = solve(a, torch.as_tensor(vals))
    (torch.as_tensor(w) * y).sum().backward()
    assert solve.mg.dtype == "float32" and 0 < solve.iterations < 60
    free = tphys.free_dofs
    for i in range(2):
        direct = tphys.solve_direct(alphas[i], vals[i])
        np.testing.assert_allclose(y[i].detach().numpy(), direct, rtol=0,
                                   atol=DIRECT_RTOL * np.abs(direct).max())
        K = tfem.assembly.dense_stiffness(tphys.grid, alphas[i])
        lam = np.zeros(tphys.grid.n_nodes)
        lam[free] = np.linalg.solve(K[np.ix_(free, free)], w[i])
        y_full = tphys.solve_direct(alphas[i], vals[i], only_free_dofs=False)
        g = -tphys.op.cell_bilinear(torch.as_tensor(lam)[None],
                                    torch.as_tensor(y_full)[None])[0]
        np.testing.assert_allclose(a.grad[i].numpy(), g.numpy(), rtol=0,
                                   atol=DIRECT_RTOL * g.abs().max().item())


def test_precond_dtype_resolves_and_refuses(monkeypatch):
    jphys, tphys = _physics(16)
    picked = []
    real = jmg.MultigridPreconditioner.for_grid.__func__
    monkeypatch.setattr(jmg.MultigridPreconditioner, "for_grid", classmethod(
        lambda cls, grid, **kw: picked.append(kw["dtype"])
        or real(cls, grid, **kw)))
    j_make_solver(jphys.op, jphys.profile, precond="mg")
    assert picked == ["float32"]  # the JAX package off a TPU
    for given, want in ((None, "float32"), ("bfloat16", "bfloat16"),
                        ("float32", "float32"), ("float64", "float64")):
        s = t_make_solver(tphys.op, tphys.profile, precond="mg",
                          precond_dtype=given)
        assert s.mg.dtype == want
    a32, v32, _ = _fields(tphys, 2, 0.5, 1, np.float32)
    for data, want in ((torch.float32, torch.float32),
                       (torch.float64, torch.float64)):
        s = t_make_solver(tphys.op, tphys.profile, precond="mg")
        a = torch.as_tensor(a32, dtype=data)
        c = tphys.op.coefficients(a).permute(1, 2, 3, 0).contiguous()
        _, levels = s._precond(c, None, alphas=a)
        assert {lv[0].dtype for lv in levels} == {want}
    # 'auto' keeps its f32 V-cycle at 64^2
    big = tfem.LinearEllipticPhysics("fom", "ND",
                                     tfem.StructuredTriGrid(64, 64),
                                     device="cpu")
    assert t_make_solver(big.op, big.profile).mg.dtype == "float32"
    for bad in ("float16", "bf16", "", torch.bfloat16):
        with pytest.raises(ValueError, match="'bfloat16', 'float32' or "
                                             "'float64'"):
            t_make_solver(tphys.op, tphys.profile, precond="mg",
                          precond_dtype=bad)
        with pytest.raises(ValueError, match="'bfloat16', 'float32'"):
            tmg.MultigridPreconditioner.for_grid(tphys.grid, dtype=bad)


def _bf16_inputs(n, B, seed):
    """bf16 K1 inputs of lognormal conductivities as (JAX, torch) triples
    holding the same values."""
    grid = jfem.StructuredTriGrid(n, n)
    rng = np.random.default_rng(seed)
    alphas = np.exp(rng.normal(0, 1.0, (B, grid.n_cells)))
    coefs = np.moveaxis(np.asarray(jfem.StencilOperator(grid).coefficients(
        jnp.asarray(alphas))), 0, -1)
    v = rng.normal(size=(n + 1, n + 1, B))
    mask = jfem.DirichletProfile(grid).free_mask.reshape(n + 1, n + 1, 1)
    j = tuple(jnp.asarray(x, jnp.bfloat16) for x in (coefs, v, mask))
    t = tuple(torch.as_tensor(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16).contiguous() for x in j)
    return j, t


@pytest.mark.parametrize("n,B,seed", [(8, 16, 0), (16, 20, 1)])
def test_k1_bf16_plain_apply_against_jax(n, B, seed):
    (jc, jv, jm), (tc, tv, tm) = _bf16_inputs(n, B, seed)
    got = apply_stencil(tc, tv, tm)
    assert got.dtype == torch.bfloat16 and apply_stencil.launches == 0
    got = got.double().numpy()
    pallas = np.asarray(j_apply_stencil(jc, jv, jm, interpret=True)
                        .astype(jnp.float64))
    blast = np.asarray((jm * j_blast(jc, jv)).astype(jnp.float64))
    exact = (np.asarray(jm.astype(jnp.float64))
             * np.asarray(j_blast(jc.astype(jnp.float64),
                                  jv.astype(jnp.float64))))
    scale = np.abs(exact).max()
    for other in (pallas, blast):
        np.testing.assert_allclose(got, other, rtol=0,
                                   atol=APPLY_RTOL * scale)
    # one rounding of an f32 sum: within half an ulp (2^-8 relative)
    assert np.all(np.abs(got - exact)
                  <= 2.0 ** -8 * np.abs(exact) + 1e-6 * scale)
    # the contract: upcast, the f32 apply, one rounding
    want = (tm.float() * _apply_stencil_blast(tc.float(), tv.float())).to(
        torch.bfloat16)
    assert torch.equal(apply_stencil(tc, tv, tm).view(torch.int16),
                       want.view(torch.int16))


def test_k2_k3_refuse_bf16_and_k1_plans_size_the_2_byte_element():
    c4 = torch.zeros(4, 6, 6, 3, dtype=torch.bfloat16)
    v = torch.zeros(6, 6, 3, dtype=torch.bfloat16)
    m = torch.ones(6, 6, 1, dtype=torch.bfloat16)
    for fn in (apply_stencil_sym, apply_stencil_sym_blocked):
        with pytest.raises(TypeError, match="float32 or float64"):
            fn(c4, v, m)
    with pytest.raises(TypeError, match="bfloat16"):
        apply_stencil(torch.zeros(7, 6, 6, 3, dtype=torch.half), v.half(),
                      m.half())
    for (Ny, Nx), B in (((65, 65), 16384), ((5, 5), 16384), ((33, 33), 7),
                        ((129, 129), 1)):
        p32 = launch_plan(Ny, Nx, B, torch.float32, 132)
        p = launch_plan(Ny, Nx, B, torch.bfloat16, 132)
        # scalar loads, chunks of up to 512 bytes: twice the f32 entries
        assert p.vec == 1 and p.chunk * 2 <= 512
        assert p.chunk == min(256, 1 << (B - 1).bit_length())
        assert p.chunk >= p32.chunk
        lanes = p.chunk
        assert lanes & (lanes - 1) == 0 and p.threads % lanes == 0
        assert p.threads <= 256 and p.blocks == p.tiles_y * p.tiles_x \
            * -(-B // p.chunk)
        assert p.tiles_y * p.tile_rows >= Ny > (p.tiles_y - 1) * p.tile_rows
        assert p.tiles_x * p.tile_cols >= Nx > (p.tiles_x - 1) * p.tile_cols


def test_bf16_vcycle_matches_jax(monkeypatch):
    n, B = 32, 4
    jphys, tphys = _physics(n)
    alphas, _, rng = _fields(jphys, B, 1.3, 5, np.float32)
    jm = jmg.MultigridPreconditioner.for_grid(jphys.grid, dtype="bfloat16")
    tm = tmg.MultigridPreconditioner.for_grid(tphys.grid, dtype="bfloat16")
    jl = jax.jit(jm.setup)(jnp.asarray(alphas))
    tl = tm.setup(torch.as_tensor(alphas))
    for (jc, _, jmask), tlev in zip(jl, tl):
        assert tlev[0].is_contiguous()  # the kernels' coefficients
        # the port's levels hold no inverse diagonal: the steps form it
        for x, y in zip((jc, jmask), tlev):
            assert y.dtype == torch.bfloat16
            assert np.array_equal(np.asarray(x.astype(jnp.float32)),
                                  y.float().numpy())
    mask = tphys.profile.free_mask.reshape(n + 1, n + 1, 1)
    r = (rng.normal(size=(n + 1, n + 1, B)) * mask).astype(np.float32)
    seen = []
    for name in ("vcycle_presmooth", "vcycle_restrict", "vcycle_correct",
                 "vcycle_smooth", "vcycle_coarse"):
        def counted(coefs, m, r, *args, _real=getattr(tmg, name)):
            seen.append((coefs.dtype, m.dtype, r.dtype))
            return _real(coefs, m, r, *args)

        monkeypatch.setattr(tmg, name, counted)
    zt = tm.apply(tl, torch.as_tensor(r))
    assert zt.dtype == torch.float32
    assert len(seen) == tm.launches_per_cycle
    assert set(seen) == {(torch.bfloat16,) * 3}
    zj = np.asarray(jax.jit(jm.apply)(jl, jnp.asarray(r)))
    assert zj.dtype == np.float32
    np.testing.assert_allclose(zt.numpy(), zj, rtol=0,
                               atol=VCYCLE_RTOL * np.abs(zj).max())


def test_bf16_preconditioned_solve_of_high_contrast_fields(monkeypatch):
    """The JAX package's high-contrast case (sigma = 1.3, left/right
    values 0/1) at 32^2, precond='mg' asked for explicitly, B = 4."""
    n, B, tol = 32, 4, 2e-6
    jphys, tphys = _physics(n)
    alphas, vals, _ = _fields(jphys, B, 1.3, 3, np.float32)
    jsolve = jax.jit(j_make_solver(jphys.op, jphys.profile, precond="mg",
                                   precond_dtype="bfloat16", tol=tol))
    yj = np.asarray(jsolve(jnp.asarray(alphas), jnp.asarray(vals)))
    seen = set()
    from generative_physics_informed_pde_tpu_torch.fem import batched_solver
    # the outer matvec through K1, every V-cycle step in bf16
    for mod, name in ((batched_solver, "apply_stencil"),
                      *((tmg, f"vcycle_{step}") for step in (
                          "presmooth", "restrict", "correct", "smooth",
                          "coarse"))):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda c, *args, real=real,
                            mod=mod: seen.add((mod.__name__, c.dtype))
                            or real(c, *args))
    solve = t_make_solver(tphys.op, tphys.profile, precond="mg",
                          precond_dtype="bfloat16", tol=tol)
    a, b = torch.as_tensor(alphas), torch.as_tensor(vals)
    y = solve(a, b)
    assert y.dtype == torch.float32 and 0 < solve.iterations < solve.maxiter
    assert seen == {(tmg.__name__, torch.bfloat16),
                    (batched_solver.__name__, torch.float32)}
    # true residual of K_ff y_f = f_eff, in f64
    free = tphys.free_dofs
    a64, b64 = a.double(), b.double()
    f_eff = tphys.effective_force(a64, b64)[:, free]
    y0 = torch.zeros(B, tphys.grid.n_nodes, dtype=torch.float64)
    y0[:, free] = y.double()
    Ky = tphys.op.matvec(a64, y0)[:, free]
    rel = (Ky - f_eff).norm(dim=1) / f_eff.norm(dim=1)
    assert bool(torch.isfinite(y).all()) and bool((rel < 10 * tol).all()), rel
    np.testing.assert_allclose(y.numpy(), yj, rtol=0,
                               atol=SOLVE_RTOL * np.abs(yj).max())
