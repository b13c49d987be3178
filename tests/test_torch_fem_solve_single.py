"""The port's single-system full-order solve against the JAX package's.

``fem.cg``, ``make_fom_solver`` (a ``torch.autograd.Function`` with the
reference's implicit-function VJP), ``LinearEllipticPhysics.solve_full`` /
``solve`` / ``solve_batched_vmap`` and the ``coo_matvec`` oracle, each on
the same inputs (numpy, seeded) in both packages, f64.

Tolerances (relative to the largest entry): ``cg`` on a dense SPD matrix
1e-12 with equal iteration counts; the solves 1e-10 (both run Jacobi-PCG
to 1e-10 with sums in another order); their gradients 1e-8;
``solve_batched_vmap`` against the port's loop of ``solve`` calls 1e-12
(the same iterates, selected per system) and against ``solve_batched``
1e-8 (another stopping rule); ``coo_matvec`` 1e-13.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu_torch import fem as tfem


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: these are many small ops, which slow down by
    tens of times when the test workers' threads contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _problem(ptype, n, seed, B=1):
    """(jax physics, port physics, alphas (B, n_cells), bc values (B,
    n_constrained), force (B, n_nodes), cotangent weights (B, n_nodes))."""
    jp = jfem.LinearEllipticPhysics("fom", ptype, jfem.StructuredTriGrid(n, n))
    tp = tfem.LinearEllipticPhysics("fom", ptype,
                                    tfem.StructuredTriGrid(n, n),
                                    device="cpu")
    rng = np.random.default_rng(seed)
    alphas = np.exp(0.6 * rng.normal(size=(B, jp.grid.n_cells)))
    bce = jfem.BoundaryConditionEnsemble.from_factory(ptype, B, rng)
    bce.register_function_space("fom", jp.grid)
    vals = np.asarray(bce.constrained_values("fom"))
    f = rng.normal(size=(B, jp.grid.n_nodes))
    w = rng.normal(size=(B, jp.grid.n_nodes))
    return jp, tp, alphas, vals, f, w


def test_cg_matches_jax():
    rng = np.random.default_rng(0)
    n = 40
    A = rng.normal(size=(n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.normal(size=n)
    d = np.diag(A)
    for precond in (False, True):
        kw = dict(tol=1e-12, maxiter=500)
        jr = jfem.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                     precond=(lambda r: r / jnp.asarray(d)) if precond
                     else None, **kw)
        At, dt = torch.tensor(A), torch.tensor(d)
        tr = tfem.cg(lambda v: At @ v, torch.as_tensor(b),
                     precond=(lambda r: r / dt) if precond else None, **kw)
        assert tr.iters == int(jr.iters) > 0
        assert _rel(tr.x, jr.x) <= 1e-12
        assert float(tr.resnorm) <= 1e-12 * np.linalg.norm(b)
    # a start vector and a cut iteration count
    x0 = rng.normal(size=n)
    jr = jfem.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                 jnp.asarray(x0), maxiter=3)
    tr = tfem.cg(lambda v: At @ v, torch.as_tensor(b), torch.as_tensor(x0),
                 maxiter=3)
    assert tr.iters == int(jr.iters) == 3
    assert _rel(tr.x, jr.x) <= 1e-12


@pytest.mark.parametrize("ptype", ["ND", "NDP"])
@pytest.mark.parametrize("n", [8, 16])
def test_solve_full_and_grads_match_jax(ptype, n):
    jp, tp, alphas, vals, f, w = _problem(ptype, n, seed=n)
    a, v, ff, ww = alphas[0], vals[0], f[0], w[0]
    bc_full = np.asarray(jp.profile.scatter_full(jnp.asarray(v)))
    # one JAX trace: the forward with a force and its VJP for alpha,
    # f_full and bc_full (solve_full is this solver on scattered values)
    jy, jvjp = jax.vjp(jp._solver, jnp.asarray(a), jnp.asarray(ff),
                       jnp.asarray(bc_full))
    jg = jvjp(jnp.asarray(ww))
    jy = np.asarray(jy)
    ta, tf, tb = (torch.tensor(x, requires_grad=True)
                  for x in (a, ff, bc_full))
    ty = tp._solver(ta, tf, tb)
    tg = torch.autograd.grad((torch.as_tensor(ww) * ty).sum(), (ta, tf, tb))
    assert tp._solver.iterations > 0 and tp._solver.adjoint_iterations > 0
    assert _rel(ty.detach(), jy) <= 1e-10
    for t, j in zip(tg, jg):
        assert _rel(t, j) <= 1e-8
    # the entry points: full and free dofs, with the force and without
    # (a zero force, held to the dense direct solve)
    tv = torch.as_tensor(v)
    assert _rel(tp.solve_full(torch.as_tensor(a), tv, torch.as_tensor(ff)),
                jy) <= 1e-10
    assert _rel(tp.solve(torch.as_tensor(a), tv, torch.as_tensor(ff)),
                jy[jp.free_dofs]) <= 1e-10
    assert _rel(tp.solve_full(torch.as_tensor(a), tv),
                tp.solve_direct(a, v, only_free_dofs=False)) <= 1e-9


def test_mixed_dtype_cotangents():
    """f32 alpha with an f64 force and f64 BC values: the cotangents come
    back in each primal's dtype (after tests/test_batched_solver.py:57)."""
    _, tp, alphas, vals, f, _ = _problem("NDP", 8, seed=3)
    a = torch.tensor(alphas[0], dtype=torch.float32, requires_grad=True)
    ff = torch.tensor(f[0], requires_grad=True)
    bc = tp.profile.scatter_full(torch.as_tensor(vals[0])).requires_grad_()
    y = tp._solver(a, ff, bc)
    assert y.dtype == torch.float32
    ga, gf, gb = torch.autograd.grad(y.square().sum(), (a, ff, bc))
    assert (ga.dtype, gf.dtype, gb.dtype) == (torch.float32, torch.float64,
                                              torch.float64)
    assert all(bool(torch.isfinite(g).all()) for g in (ga, gf, gb))


def test_solve_batched_vmap_freezes_each_system():
    """One system made far harder (log-conductivity std 3 against 0.6)
    runs twice the iterations of the rest; the others stop on their own
    criterion and keep their state, so each row equals its single
    solve."""
    B = 6
    jp, tp, alphas, vals, _, w = _problem("NDP", 16, seed=7, B=B)
    rng = np.random.default_rng(8)
    alphas[2] = np.exp(3.0 * rng.normal(size=alphas.shape[1]))
    ta, tv = torch.as_tensor(alphas), torch.as_tensor(vals)
    Y = tp.solve_batched_vmap(ta, tv)
    iters = tp._solver.iterations
    assert iters.shape == (B,)
    assert int(iters[2]) > 1.5 * int(iters[[0, 1, 3, 4, 5]].max())
    singles, single_iters = [], []
    for i in range(B):
        singles.append(tp.solve(ta[i], tv[i]))
        single_iters.append(tp._solver.iterations)
    assert iters.tolist() == single_iters
    assert _rel(Y, torch.stack(singles)) <= 1e-12
    jY = jp.solve_batched_vmap(jnp.asarray(alphas), jnp.asarray(vals))
    assert _rel(Y, jY) <= 1e-10
    # solve_batched stops on the worst system: the same solution to 1e-8
    assert _rel(tp.solve_batched(ta, tv), Y) <= 1e-8

    # gradients: per-system adjoint solves under the same freeze
    ww = torch.as_tensor(w[:, :tp.dim_out])
    ta_ = ta.clone().requires_grad_()
    tv_ = tv.clone().requires_grad_()
    tg = torch.autograd.grad((ww * tp.solve_batched_vmap(ta_, tv_)).sum(),
                             (ta_, tv_))
    assert tp._solver.adjoint_iterations.shape == (B,)
    jg = jax.grad(lambda a_, v_: jnp.sum(jnp.asarray(ww.numpy())
                                         * jp.solve_batched_vmap(a_, v_)),
                  argnums=(0, 1))(jnp.asarray(alphas), jnp.asarray(vals))
    for t, j in zip(tg, jg):
        assert _rel(t, j) <= 1e-8


def test_coo_matvec_matches_jax_and_the_stencil():
    grid = tfem.StructuredTriGrid(6, 4)
    rng = np.random.default_rng(11)
    alpha = np.exp(rng.normal(size=grid.n_cells))
    v = rng.normal(size=grid.n_nodes)
    got = tfem.coo_matvec(grid, alpha, v)
    assert _rel(got, jfem.coo_matvec(jfem.StructuredTriGrid(6, 4), alpha, v)) \
        <= 1e-13
    op = tfem.StencilOperator(grid)
    assert _rel(op.matvec(torch.as_tensor(alpha), torch.as_tensor(v)), got) \
        <= 1e-13
