"""The port's virtual observables against the JAX package: constraint
assembly per sampler, the flux operator, linear-Gaussian conditioning, the
Gamma-hyperprior precision update, the failure containment, the energy
arm, the temperature schedules and the spec factory.  The tests follow
``tests/test_constraints.py`` one for one and hold the port to the JAX
package on the same inputs.

Geometry: the 'NDP' pair of a 2x2 ROM refined twice (8x8 fine cells, 9^2
nodes, 63 free dofs), three fields from a numpy seed; the true solutions
are the JAX package's solves.  Random test functions are injected: the
port's ``sketch_normals`` / ``rbf_uniforms`` and the JAX module's
``jax.random.normal`` / ``uniform`` (through a stand-in for its ``jax``
name) hand out one numpy seed's draws in call order.  A replaced JAX
sampler runs once per trace, so the JAX ensembles sample eagerly here
(``_sample_jit`` replaced by the plain call) and the energy update runs
under ``jax.disable_jit()``, where its ``fori_loop`` is a Python loop.

Tolerances (f64): Gamma, alpha and the flux entries 1e-12; conditioning,
precision update and the energy update 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.constraints import (
    virtual_observables as jvo)
from generative_physics_informed_pde_tpu.constraints.flux import (
    FluxConstraintOperator as JFlux)
from generative_physics_informed_pde_tpu_torch import fem as tfem
from generative_physics_informed_pde_tpu_torch import constraints as tc
from generative_physics_informed_pde_tpu_torch.constraints import (
    virtual_observables as tvo)

N = 3


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class _JaxRandom:
    """``jax.random`` with ``normal`` and ``uniform`` drawing from numpy."""

    def __init__(self, rng):
        self.rng = rng

    def normal(self, key, shape, dtype=jnp.float64):
        return jnp.asarray(self.rng.standard_normal(tuple(shape)), dtype)

    def uniform(self, key, shape=(), dtype=jnp.float64, **kw):
        return jnp.asarray(self.rng.random(tuple(shape)), dtype)

    def __getattr__(self, name):
        return getattr(jax.random, name)


class _Jax:
    def __init__(self, rng):
        self.random = _JaxRandom(rng)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.fixture()
def inject(monkeypatch):
    """Same-order test-function draws in both packages from one seed."""

    def install(seed):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        monkeypatch.setattr(jvo, "jax", _Jax(rj))
        monkeypatch.setattr(
            tvo, "sketch_normals", lambda shape, g, dtype, device:
            torch.as_tensor(rt.standard_normal(tuple(shape)), dtype=dtype))
        monkeypatch.setattr(
            tvo, "rbf_uniforms", lambda shape, g, dtype, device:
            torch.as_tensor(rt.random(tuple(shape)), dtype=dtype))

    return install


@pytest.fixture(scope="module")
def setup():
    jphys = jfem.make_fom_rom_pair("NDP", 2, 2, 2)
    tphys = tfem.make_fom_rom_pair("NDP", 2, 2, 2, device="cpu")
    fom = jphys["fom"]
    rng = np.random.default_rng(0)
    logx = rng.normal(0.2, 0.4, (N, fom.grid.n_cells))
    bce = jfem.BoundaryConditionEnsemble.from_factory("NDP", N, rng)
    bce.register_function_space("fom", fom.grid)
    bce.register_function_space("rom", jphys["rom"].grid)
    bcv = np.asarray(bce.constrained_values("fom"))
    jq = jvo.QuerryPointEnsemble(physics=fom, X_DG=jnp.asarray(logx),
                                 bc_values=jnp.asarray(bcv))
    tq = tc.QuerryPointEnsemble(physics=tphys["fom"],
                                X_DG=torch.as_tensor(logx),
                                bc_values=torch.as_tensor(bcv))
    Y = np.asarray(fom.solve_batched(jnp.exp(jq.X_DG), jq.bc_values))
    return jphys, tphys, jq, tq, Y, bce


def _residual(Gamma, alpha, Y):
    Gamma, alpha, Y = (np.asarray(a) for a in (Gamma, alpha, Y))
    return np.abs(np.einsum("nmd,nd->nm", Gamma, Y) - alpha)


def _coords(phys):
    fom = phys["fom"]
    return fom.grid.node_coords[fom.profile.free_dofs]


def _samplers(kind, jphys, tphys):
    """(JAX sampler, port sampler) of one kind on the setup's grids."""
    if kind == "cgr":
        return (jvo.CoarseGrainedResidualSampler(W=jphys["W"]),
                tc.CoarseGrainedResidualSampler(W=tphys["W"]))
    if kind == "gaussian":
        return (jvo.GaussianSketchingSampler(N_aux=5),
                tc.GaussianSketchingSampler(N_aux=5))
    if kind == "rbf":
        return (jvo.RadialBasisFunctionSampler(l=0.3, N_aux=4,
                                               coords=_coords(jphys)),
                tc.RadialBasisFunctionSampler(l=0.3, N_aux=4,
                                              coords=_coords(tphys)))
    if kind == "flux":
        return (jvo.FluxConstrainSampler(
                    operator=JFlux(coarse=jphys["rom"].grid,
                                   fine=jphys["fom"].grid),
                    physics=jphys["fom"]),
                tc.FluxConstrainSampler(
                    operator=tc.FluxConstraintOperator(
                        coarse=tphys["rom"].grid, fine=tphys["fom"].grid),
                    physics=tphys["fom"]))
    parts = [_samplers(k, jphys, tphys) for k in ("cgr", "flux", "gaussian",
                                                  "rbf")]
    return (jvo.ConcatenatedSamplers([p[0] for p in parts]),
            tc.ConcatenatedSamplers([p[1] for p in parts]))


def _ensembles(jphys, tphys, jq, tq, kind, **kw):
    """A JAX and a port constrain ensemble, f64; the JAX one samples
    eagerly from now on (so every resample draws anew)."""
    js, ts = _samplers(kind, jphys, tphys)
    jv = jvo.VirtualObservablesEnsemble(jq, js, dtype=jnp.float64, **kw)
    jv._sample_jit = lambda key: js.sample(jq, key)
    tv = tc.VirtualObservablesEnsemble(tq, ts, dtype=torch.float64, **kw)
    return jv, tv


def _gen():
    return torch.Generator().manual_seed(0)


# ------------------------------------------------------ constraint assembly
@pytest.mark.parametrize("kind", ["cgr", "gaussian", "rbf", "flux",
                                  "concatenated"])
def test_gamma_and_alpha_per_sampler_match_jax(setup, inject, kind):
    jphys, tphys, jq, tq, Y, _ = setup
    inject(3)
    js, ts = _samplers(kind, jphys, tphys)
    Gj, aj = js.sample(jq, jax.random.PRNGKey(0))
    Gt, at = ts.sample(tq, _gen())
    assert Gt.shape == Gj.shape == (N, ts.m, tq.dim_out)
    assert _rel(Gt, Gj) <= 1e-12 and _rel(at, aj) <= 1e-12
    np.testing.assert_array_equal(ts.precision_mask(), js.precision_mask())
    assert ts.is_constant == js.is_constant
    # the infinite-precision constraints hold at the true solution
    if kind in ("cgr", "gaussian", "rbf"):
        assert _residual(Gt, at, Y).max() < 1e-6


def test_gamma_matches_dense_assembly(setup):
    """V^T K_ff through the stencil == V^T K_ff of the dense matrix, and
    apply_Kff equals the JAX package's."""
    jphys, tphys, jq, tq, Y, _ = setup
    fom = tphys["fom"]
    V = np.random.default_rng(3).normal(size=(N, fom.dim_out, 4))
    Gamma, alpha = tq.construct_querry_weak_galerkin(torch.as_tensor(V))
    free, con = fom.free_dofs, fom.constrained_dofs
    for n in range(N):
        K = tfem.dense_stiffness(fom.grid, np.exp(tq.X_DG[n].numpy()))
        np.testing.assert_allclose(Gamma[n].numpy(),
                                   V[n].T @ K[np.ix_(free, free)],
                                   rtol=1e-9, atol=1e-10)
        f_eff = -K[np.ix_(free, con)] @ tq.bc_values[n].numpy()
        np.testing.assert_allclose(alpha[n].numpy(), V[n].T @ f_eff,
                                   rtol=1e-9, atol=1e-10)
    assert _rel(tq.apply_Kff(torch.as_tensor(V)),
                jq.apply_Kff(jnp.asarray(V))) <= 1e-12
    assert _rel(tq.f_eff(), jq.f_eff()) <= 1e-12


def test_fem_helpers_of_the_slice_match_jax(setup):
    """scatter_full / restrict_free, apply_coeff (broadcast coefficients),
    matvec, diagonal, effective_force, reduced_system_matvec and
    scatter_restricted_solution, f64."""
    jphys, tphys, jq, tq, Y, _ = setup
    Y = np.array(Y)
    jf, tf = jphys["fom"], tphys["fom"]
    rng = np.random.default_rng(4)
    a = np.exp(rng.normal(size=(N, jf.grid.n_cells)))
    bcv = np.array(jq.bc_values)
    v = rng.normal(size=(N, jf.grid.n_nodes))
    full_t = tf.profile.scatter_full(torch.as_tensor(bcv),
                                     torch.as_tensor(Y))
    full_j = jf.profile.scatter_full(bcv, Y)
    np.testing.assert_array_equal(full_t.numpy(), full_j)
    np.testing.assert_array_equal(tf.profile.restrict_free(full_t).numpy(), Y)
    np.testing.assert_array_equal(
        tf.scatter_restricted_solution(torch.as_tensor(Y[0]),
                                       torch.as_tensor(bcv[0])).numpy(),
        jf.scatter_restricted_solution(Y[0], bcv[0]))
    coefs = tf.op.coefficients(torch.as_tensor(a[0]))
    grids = tf.op.to_nodegrid(torch.as_tensor(v))
    got = tf.op.apply_coeff(coefs[None], grids)
    ref = jf.op.apply_coeff(jnp.asarray(coefs.numpy())[None],
                            jf.op.to_nodegrid(jnp.asarray(v)))
    assert got.shape == (N, 9, 9) and _rel(got, ref) <= 1e-13
    for n in range(N):
        assert _rel(tf.op.matvec(torch.as_tensor(a[n]), torch.as_tensor(v[n])),
                    jf.op.matvec(jnp.asarray(a[n]), jnp.asarray(v[n]))) \
            <= 1e-13
        assert _rel(tf.op.diagonal(torch.as_tensor(a))[n],
                    jf.op.diagonal(jnp.asarray(a[n]))) == 0
        assert _rel(tf.effective_force(torch.as_tensor(a),
                                       torch.as_tensor(bcv))[n],
                    jf.effective_force(jnp.asarray(a[n]),
                                       jnp.asarray(bcv[n]))) <= 1e-13
        assert _rel(tf.reduced_system_matvec(torch.as_tensor(a[n]))(
                        torch.as_tensor(v[n])),
                    jf.reduced_system_matvec(jnp.asarray(a[n]))(
                        jnp.asarray(v[n]))) <= 1e-13


def test_flux_entries_and_reduced_system_match_jax(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    jop = JFlux(coarse=jphys["rom"].grid, fine=jphys["fom"].grid)
    top = tc.FluxConstraintOperator(coarse=tphys["rom"].grid,
                                    fine=tphys["fom"].grid)
    for mine, ref in zip(top._entries, jop._entries):
        np.testing.assert_array_equal(mine, ref)
    prof = tphys["fom"].profile
    G, rhs = top.assemble_reduced(tq.alpha, tq.bc_values, prof.free_dofs,
                                  prof.constrained_dofs)
    for n in range(N):
        Gj, rj = jop.assemble_reduced(jq.alpha[n], jq.bc_values[n],
                                      prof.free_dofs, prof.constrained_dofs)
        assert _rel(G[n], Gj) <= 1e-12 and _rel(rhs[n], rj) <= 1e-12
    # one field alone gives the same rows as in the batch
    G0, _ = top.assemble_reduced(tq.alpha[0], tq.bc_values[0],
                                 prof.free_dofs, prof.constrained_dofs)
    np.testing.assert_array_equal(G0.numpy(), G[0].numpy())


def test_flux_constraints_exact_for_linear_solution():
    """alpha=1, ND BCs => u = x; every coarse-cell net flux vanishes."""
    phys = tfem.make_fom_rom_pair("ND", 2, 2, 2, device="cpu")
    fom = phys["fom"]
    op = tc.FluxConstraintOperator(coarse=phys["rom"].grid, fine=fom.grid)
    G = op.gamma_full(torch.ones(fom.grid.n_cells, dtype=torch.float64))
    u = torch.as_tensor(fom.grid.node_coords[:, 0])
    np.testing.assert_allclose((G @ u).numpy(), 0.0, atol=1e-10)


def test_flux_constraints_small_at_discrete_solution(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    _, ts = _samplers("flux", jphys, tphys)
    Gamma, alpha = ts.sample(tq, _gen())
    scale = np.abs(Gamma.numpy()).sum(-1).mean()
    assert _residual(Gamma, alpha, Y).max() / scale < 0.5
    assert np.all(ts.precision_mask() > 0)  # learnable


def test_flux_operator_rejects_unequal_refinement():
    op = tc.FluxConstraintOperator(coarse=tfem.StructuredTriGrid(4, 2),
                                   fine=tfem.StructuredTriGrid(8, 8))
    with pytest.raises(ValueError, match="SAME integer factor"):
        op._entries


# ------------------------------------------------------------- conditioning
def test_condition_ensemble_and_precision_beta_match_jax():
    rng = np.random.default_rng(5)
    n, m, d = 4, 7, 30
    Gamma = rng.normal(size=(n, m, d))
    alpha = rng.normal(size=(n, m))
    G = rng.normal(size=(n, d))
    PREC = rng.uniform(1.0, 3.0, (n, d))
    vo_var = rng.uniform(0.0, 0.1, m)
    vo_var[:3] = 0.0  # exact constraints: the jitter carries them
    mt, vt = tc.condition_ensemble(*(torch.as_tensor(x) for x in (
        Gamma, alpha, G, PREC, vo_var)), 1e-12)
    mj, vj = jvo.condition_ensemble(*(jnp.asarray(x) for x in (
        Gamma, alpha, G, PREC, vo_var)), 1e-12)
    assert _rel(mt, mj) <= 1e-10 and _rel(vt, vj) <= 1e-10
    w = np.array([1.0, 0.0, 1.0, 1.0])
    for weights in (None, w):
        bt = tc.gamma_precision_beta(
            *(torch.as_tensor(x) for x in (Gamma, alpha, G, PREC)),
            None if weights is None else torch.as_tensor(weights))
        bj = jvo.gamma_precision_beta(
            *(jnp.asarray(x) for x in (Gamma, alpha, G, PREC)),
            None if weights is None else jnp.asarray(weights))
        assert _rel(bt, bj) <= 1e-10


def test_conditioning_matches_dense_bayes_and_jax(setup, inject):
    jphys, tphys, jq, tq, Y, _ = setup
    inject(5)
    jv, tv = _ensembles(jphys, tphys, jq, tq, "gaussian")
    rng = np.random.default_rng(5)
    G = rng.normal(size=(N, tq.dim_out))
    PREC = rng.uniform(1.0, 3.0, (N, tq.dim_out))
    tv.update(torch.as_tensor(G), torch.as_tensor(PREC), 0)
    jv.update(jnp.asarray(G), jnp.asarray(PREC), 0)
    assert _rel(tv.mean, jv.mean) <= 1e-10
    assert _rel(tv.vars, jv.vars) <= 1e-10
    n = 1
    Gm, al = tv.Gamma[n].numpy(), tv.alpha[n].numpy()
    cov = np.diag(1.0 / PREC[n])
    S = Gm @ cov @ Gm.T + np.diag(tv.vo_variances.numpy() + 1e-10)
    gain = cov @ Gm.T @ np.linalg.inv(S)
    mean = G[n] + gain @ (al - Gm @ G[n])
    np.testing.assert_allclose(tv.mean[n].numpy(), mean, rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(
        tv.vars[n].numpy(),
        np.maximum(np.diag(cov - gain @ Gm @ cov), 1e-12), rtol=1e-6,
        atol=1e-9)


def test_conditioning_pulls_towards_solution(setup, inject):
    jphys, tphys, jq, tq, Y, _ = setup
    inject(2)
    js = jvo.ConcatenatedSamplers([
        jvo.CoarseGrainedResidualSampler(W=jphys["W"]),
        jvo.GaussianSketchingSampler(N_aux=10)])
    ts = tc.ConcatenatedSamplers([
        tc.CoarseGrainedResidualSampler(W=tphys["W"]),
        tc.GaussianSketchingSampler(N_aux=10)])
    jv = jvo.VirtualObservablesEnsemble(jq, js, dtype=jnp.float64)
    tv = tc.VirtualObservablesEnsemble(tq, ts, dtype=torch.float64)
    G = Y + np.random.default_rng(2).normal(0, 0.3, Y.shape)
    PREC = np.full(Y.shape, 1.0 / 0.3 ** 2)
    tv.update(torch.as_tensor(G), torch.as_tensor(PREC), 0)
    jv.update(jnp.asarray(G), jnp.asarray(PREC), 0)
    assert _rel(tv.mean, jv.mean) <= 1e-10
    assert np.linalg.norm(tv.mean.numpy() - Y) < np.linalg.norm(G - Y)
    assert float(tv.vars.max()) <= float((1.0 / PREC).max()) + 1e-9
    r_post = _residual(tv.Gamma, tv.alpha, tv.mean)
    assert r_post.max() < 1e-3 * _residual(tv.Gamma, tv.alpha, G).max()


def test_prior_tempering(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    G = Y + np.random.default_rng(11).normal(0, 0.3, Y.shape)
    PREC = np.full(Y.shape, 1.0 / 0.3 ** 2)
    jv, tv = _ensembles(jphys, tphys, jq, tq, "cgr",
                        prior_precision_factor=0.1)
    _, ref = _ensembles(jphys, tphys, jq, tq, "cgr")
    tv.update(torch.as_tensor(G), torch.as_tensor(PREC), 0)
    jv.update(jnp.asarray(G), jnp.asarray(PREC), 0)
    ref.update(torch.as_tensor(G), torch.as_tensor(PREC), 0)
    assert _rel(tv.mean, jv.mean) <= 1e-10
    assert bool(torch.all(tv.vars >= ref.vars - 1e-12))
    r = _residual(tv.Gamma, tv.alpha, tv.mean)
    assert r.max() < 1e-3 * _residual(tv.Gamma, tv.alpha, G).max()


def test_precision_learning_matches_jax(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    jv, tv = _ensembles(jphys, tphys, jq, tq, "flux")
    rng = np.random.default_rng(1)
    G = rng.normal(size=(N, tq.dim_out))
    PREC = np.ones((N, tq.dim_out))
    for it in range(2):  # the second update learns the precision
        tv.update(torch.as_tensor(G), torch.as_tensor(PREC), it)
        jv.update(jnp.asarray(G), jnp.asarray(PREC), it)
        assert _rel(tv._prec_beta, jv._prec_beta) <= 1e-10
        assert _rel(tv.vo_variances, jv.vo_variances) <= 1e-10
        assert _rel(tv.mean, jv.mean) <= 1e-10
        assert _rel(tv.vars, jv.vars) <= 1e-10
    assert tv._prec_alpha == jv._prec_alpha
    assert tv.vo_variances.shape == (tv.m,)


# -------------------------------------------------------------- containment
def _update_both(jv, tv, G, PREC, it, expect_warning=True):
    if expect_warning:
        with pytest.warns(UserWarning, match="non-finite moments"):
            tv.update(torch.as_tensor(G), torch.as_tensor(PREC), it)
        with pytest.warns(UserWarning, match="non-finite moments"):
            jv.update(jnp.asarray(G), jnp.asarray(PREC), it)
    else:
        tv.update(torch.as_tensor(G), torch.as_tensor(PREC), it)
        jv.update(jnp.asarray(G), jnp.asarray(PREC), it)
    for name in ("mean", "vars", "vo_variances"):
        got, ref = getattr(tv, name).numpy(), np.asarray(getattr(jv, name))
        assert np.isfinite(got).all(), name
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14,
                                   err_msg=name)
    fb_t, fb_j = tv._fallback_mask, jv._fallback_mask
    assert (fb_t is None) == (fb_j is None)
    if fb_t is not None:
        np.testing.assert_array_equal(fb_t.numpy(), np.asarray(fb_j))


@pytest.mark.parametrize("poison", ["nan_prior", "inf_prior",
                                    "nan_prior_and_precision",
                                    "cholesky_failure"])
def test_containment_paths_match_jax(setup, poison):
    """A non-finite prior (NaN, +inf, NaN precision too) or a failed
    Cholesky in one sample: the others are untouched, the stored moments
    are finite, the stand-in is flagged and kept out of the next precision
    update -- in both packages alike, over two updates."""
    jphys, tphys, jq, tq, Y, _ = setup
    jv, tv = _ensembles(jphys, tphys, jq, tq, "flux")
    rng = np.random.default_rng(7)
    G = rng.normal(size=(N, tq.dim_out))
    PREC = np.ones((N, tq.dim_out))
    if poison == "nan_prior":
        G[1, 0] = np.nan
    elif poison == "inf_prior":
        G[0] = np.inf
    elif poison == "nan_prior_and_precision":
        G[0], PREC[0] = np.nan, np.nan
    else:
        # a negative prior precision makes sample 2's Schur system negative
        # definite: its Cholesky fails (cholesky_ex info > 0 in the port,
        # NaN in the JAX package)
        PREC[2] = -1.0
    _update_both(jv, tv, G, PREC, 0)
    bad = tv._fallback_mask.numpy()
    assert bad.sum() == 1
    if poison == "inf_prior":
        assert np.abs(tv.mean[0].numpy()).max() < 1e6  # inf -> 0
    if poison == "nan_prior_and_precision":
        assert float(tv.vars[0].max()) >= 1e5  # the neutral stand-in
    _update_both(jv, tv, G, PREC, 1)
    assert np.isfinite(tv.vo_variances.numpy()).all()


def test_all_samples_failed_keeps_the_precision(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    jv, tv = _ensembles(jphys, tphys, jq, tq, "flux")
    nan = np.full((N, tq.dim_out), np.nan)
    _update_both(jv, tv, nan, nan, 0)
    before = tv.vo_variances.clone()
    _update_both(jv, tv, nan, nan, 1)
    assert torch.equal(tv.vo_variances, before)


def test_vo_dump_on_failure(setup, tmp_path, monkeypatch):
    jphys, tphys, jq, tq, Y, _ = setup
    _, tv = _ensembles(jphys, tphys, jq, tq, "flux")
    G = np.zeros((N, tq.dim_out))
    G[2, 3] = np.nan
    path = tmp_path / "vo.npz"
    monkeypatch.setenv("GPIPDE_VO_DUMP", str(path))
    with pytest.warns(UserWarning, match="1/3 samples"):
        tv.update(torch.as_tensor(G), torch.ones(N, tq.dim_out,
                                                 dtype=torch.float64), 4)
    with np.load(path) as d:
        assert d["bad"].tolist() == [False, False, True]
        assert int(d["iteration"]) == 4 and d["Gamma"].shape == (N, tv.m, 63)


def test_f32_conditioning_survives_badly_scaled_schur_system():
    """The equilibrated conditioning of a synthetic system with a 6-decade
    spread of constraint-row scales: f32 stays finite and tracks the f64
    result (which equals the JAX package's), variances contract."""
    rng = np.random.default_rng(7)
    n, m, d = 3, 48, 400
    scales = np.logspace(-1, 5, m)
    Gamma = scales[:, None] * rng.normal(size=(m, d)) / np.sqrt(d)
    Gamma = np.broadcast_to(Gamma, (n, m, d))
    alpha = np.einsum("nmd,nd->nm", Gamma, rng.normal(size=(n, d)))
    G = rng.normal(size=(n, d))
    PREC = np.exp(rng.normal(0.0, 1.0, size=(n, d)))
    vo_var = np.zeros(m)

    def run(dtype, eps):
        out = tc.condition_ensemble(*(torch.as_tensor(np.array(x),
                                                      dtype=dtype)
                                      for x in (Gamma, alpha, G, PREC,
                                                vo_var)), eps)
        return tuple(o.numpy() for o in out)

    m32, v32 = run(torch.float32, 1e-6)
    m64, v64 = run(torch.float64, 1e-12)
    mj, vj = jvo.condition_ensemble(*(jnp.asarray(x) for x in (
        Gamma, alpha, G, PREC, vo_var)), 1e-12)
    assert np.isfinite(m32).all() and np.isfinite(v32).all()
    assert np.linalg.norm(m64 - mj) / np.linalg.norm(mj) < 1e-8
    assert np.linalg.norm(m32 - m64) / np.linalg.norm(m64) < 1e-2
    assert np.all(v64 <= 1.0 / PREC + 1e-9)
    assert np.median(np.abs(v32 - v64) / (np.abs(v64) + 1e-12)) < 5e-2


# ------------------------------------------------------------------- energy
def _energy(jphys, tphys, jq, tq, n_iter, n_aux=6):
    js = jvo.RadialBasisFunctionSampler(l=0.3, N_aux=n_aux,
                                        coords=_coords(jphys))
    ts = tc.RadialBasisFunctionSampler(l=0.3, N_aux=n_aux,
                                       coords=_coords(tphys))
    return (jvo.EnergyVirtualObservablesEnsemble(jq, n_iter, js,
                                                 dtype=jnp.float64),
            tc.EnergyVirtualObservablesEnsemble(tq, n_iter, ts,
                                                dtype=torch.float64))


def test_energy_update_over_three_draws_matches_jax(setup, inject):
    """Three subspace iterations, each with its own injected test
    functions, from a nonzero start; then a second update (the mean is
    the carry)."""
    jphys, tphys, jq, tq, Y, _ = setup
    inject(9)
    jv, tv = _energy(jphys, tphys, jq, tq, 3)
    for v in (jv, tv):
        v.set_temperature(0.3)
    rng = np.random.default_rng(9)
    G = Y + rng.normal(0, 0.1, Y.shape)
    PREC = rng.uniform(0.5, 2.0, Y.shape)
    for it in range(2):
        tv.update(torch.as_tensor(G), torch.as_tensor(PREC), it)
        with jax.disable_jit():  # the fori_loop draws anew each iteration
            jv.update(jnp.asarray(G), jnp.asarray(PREC), it)
        assert _rel(tv.mean, jv.mean) <= 1e-10
        assert _rel(tv.vars, jv.vars) <= 1e-10


def test_energy_vo_converges_to_minimizer(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    ts = tc.RadialBasisFunctionSampler(l=0.3, N_aux=12,
                                       coords=_coords(tphys))
    vo = tc.EnergyVirtualObservablesEnsemble(tq, 25, ts, dtype=torch.float64)
    vo.force_temperature(1e-4)
    G = torch.zeros((N, tq.dim_out), dtype=torch.float64)
    vo.update(G, torch.full_like(G, 1e-6), 0)
    err = np.linalg.norm(vo.mean.numpy() - Y) / np.linalg.norm(Y)
    assert err < 0.2, err
    assert vo.vars.shape == Y.shape


def test_energy_vo_manual_temperature_and_containment(setup):
    jphys, tphys, jq, tq, Y, _ = setup
    _, vo = _energy(jphys, tphys, jq, tq, 3)
    with pytest.raises(ValueError):
        vo.set_temperature(0.0)
    vo.set_temperature(0.5)
    G = torch.zeros((N, tq.dim_out), dtype=torch.float64)
    PREC = torch.full_like(G, 1e-3)
    vo.update(G, PREC, 0)
    assert vo.temperature == 0.5 and bool(torch.isfinite(vo.mean).all())

    class ZeroSampler:
        def sample_V(self, generator, n, dtype, device):
            return torch.zeros((n, tq.dim_out, 4), dtype=dtype)

    # a singular subspace system (solve_ex info > 0) keeps the iterate
    vo2 = tc.EnergyVirtualObservablesEnsemble(tq, 2, ZeroSampler(),
                                              dtype=torch.float64)
    vo2.set_temperature(0.5)
    vo2.update(G, PREC, 0)
    np.testing.assert_array_equal(vo2.mean.numpy(), 0.0)


def test_temperature_schedules_match_jax():
    for t_cls, j_cls, n in (
            (tc.LinearTemperatureSchedule, jvo.LinearTemperatureSchedule,
             100),
            (tc.ExponentialTemperatureSchedule,
             jvo.ExponentialTemperatureSchedule, 50)):
        t, j = t_cls(1.0, 1e-4, n), j_cls(1.0, 1e-4, n)
        for it in (0, 1, 7, n - 2, n - 1, n, 10 * n):
            assert t.get_temperature(it) == j.get_temperature(it)
        assert t.get_temperature(10 * n) == pytest.approx(1e-4)
    with pytest.raises(AssertionError):
        tc.LinearTemperatureSchedule(1e-4, 1.0, 10)


def test_rbf_centers_follow_coordinate_box():
    coords = np.random.default_rng(3).uniform(5.0, 6.0, (40, 2))
    sampler = tc.RadialBasisFunctionSampler(l=0.3, N_aux=8, coords=coords)
    V = sampler.sample_V(_gen(), 2, torch.float64, "cpu")
    assert V.shape == (2, 40, 8) and float(V.max()) > 0.5


# ---------------------------------------------------------------- factories
def test_build_from_spec_matches_jax(setup, inject):
    jphys, tphys, jq, tq, Y, bce = setup
    inject(13)

    class FakeDS:
        def __init__(self, x):
            self.x = x

        def get(self, key):
            return {"X_DG": self.x, "BCE": bce}[key]

    spec = {"type": "constrain", "CGR": True, "flux": True, "N_gaussian": 3,
            "N_rbf": 2, "l_rbf": 0.2}
    jv = jvo.build_virtual_observables_ensemble(spec, FakeDS(jq.X_DG), jphys,
                                                dtype=jnp.float64)
    tv = tc.build_virtual_observables_ensemble(spec, FakeDS(tq.X_DG), tphys,
                                               dtype=torch.float64)
    assert tv.m == jv.m == 9 + 8 + 3 + 2
    assert _rel(tv.Gamma, jv.Gamma) <= 1e-12
    assert _rel(tv.alpha, jv.alpha) <= 1e-12
    spec_e = {"type": "energy", "l_rbf": 0.2, "N_rbf": 4,
              "energy_num_iterations_per_update": 2, "T_init": 1.0,
              "T_final": 0.01, "T_iterations": 100}
    ve = tc.build_virtual_observables_ensemble(spec_e, FakeDS(tq.X_DG),
                                               tphys, dtype=torch.float32)
    G = torch.zeros((N, tq.dim_out))
    ve.update(G, torch.ones_like(G), 0)
    assert ve.mean.shape == G.shape and ve.mean.dtype == torch.float32
    assert ve.temperature == 1.0
    with pytest.raises(ValueError, match="not known"):
        tc.build_virtual_observables_ensemble({"type": "x"}, FakeDS(tq.X_DG),
                                              tphys)
    with pytest.raises(ValueError, match="no samplers"):
        tc.build_virtual_observables_ensemble({"type": "constrain"},
                                              FakeDS(tq.X_DG), tphys)


def test_vo_spec_preset_matches_jax():
    from generative_physics_informed_pde_tpu.training.trainer import (
        DEFAULT_CONFIG as J_DEFAULT)
    from generative_physics_informed_pde_tpu_torch.training.trainer import (
        DEFAULT_CONFIG)

    for args, kw in ((("energy",), {"T_iterations": 500}),
                     (("constrain",), {"N_gaussian": 4}),
                     ((), {"T_iterations": 7, "N_rbf": 3})):
        assert tc.vo_spec_preset(*args, **kw) == jvo.vo_spec_preset(*args,
                                                                    **kw)
    with pytest.raises(ValueError):
        tc.vo_spec_preset("energy")
    with pytest.raises(ValueError):
        tc.vo_spec_preset("nope")
    for key in ("N_vo_update_interval", "N_vo_holdoff", "N_monte_carlo_vo"):
        assert DEFAULT_CONFIG[key] == J_DEFAULT[key]
    assert DEFAULT_CONFIG["N_vo_update_interval"] == 50
