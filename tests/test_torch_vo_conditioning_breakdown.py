"""Config 2h's f32 VO conditioning breakdown on the card, replayed on the CPU.

``tests/data/vo_failure_2h.npz`` holds the one sample whose conditioning
broke down in the port's f32 constrain update on an NVIDIA H100
(``chip_smoke.py`` phase 14, config 2h, iteration 73, sample 22 of 64),
captured through ``GPIPDE_VO_DUMP``: its Gamma (225, 16383), alpha, the
predictive moments G and PREC, and vo_var (``samples`` and ``iteration``
say where it came from).

On the CPU both packages' ``condition_ensemble`` (the JAX package's at
``constraints/virtual_observables.py:321``) condition it in f32 (eps 1e-6,
as ``update`` uses) and in f64 (eps 1e-12) with finite moments, and
their results agree.  The equilibrated Schur matrix is positive definite
by 1.3e-6 (condition 4.3e6), while two f32 assemblies of it differ by
6e-6: the JAX package's formula assembled in f32 is indefinite, and
every Cholesky of it fails, the JAX package's too.  So an f32
factorisation of this sample completes or fails by rounding alone, in
either package; the card's batched one failed.  This is a limit that the
two packages share (the JAX package's module docstring records such f32
breakdowns on an accelerator), not a fault of the port: on a failure both
fall back to the sample's prior moments, replayed here with the f32
factorisation made to fail as it did on the card.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from generative_physics_informed_pde_tpu.constraints import (
    virtual_observables as jvo)
from generative_physics_informed_pde_tpu_torch.constraints import (
    virtual_observables as tvo)

DATA = Path(__file__).resolve().parent / "data" / "vo_failure_2h.npz"
EPS = {np.float32: 1e-6, np.float64: 1e-12}
# f64: the two packages' sums differ in order only; f32: a system of
# condition ~4e6 amplifies the f32 rounding (the two f32 results differ
# by 1.6e-3 of the scale, each lies 4e-2 from the f64 result)
RTOL = {np.float32: 1e-2, np.float64: 1e-9}


@pytest.fixture(scope="module")
def sample():
    with np.load(DATA) as f:
        return {k: f[k] for k in f.files}


def _inputs(sample, dtype):
    return [sample[k].astype(dtype)
            for k in ("Gamma", "alpha", "G", "PREC", "vo_var")]


def _operand(Gamma, PREC, vo_var, eps):
    """The equilibrated Schur matrix ``condition_ensemble`` factorises,
    assembled in the inputs' dtype (numpy, the JAX package's formula)."""
    Lam = np.einsum("id,d,sd->is", Gamma, 1 / PREC, Gamma) + np.diag(vo_var)
    d = np.sqrt(np.diag(Lam))
    return Lam / d[:, None] / d[None, :] + eps * np.eye(len(d),
                                                        dtype=Lam.dtype)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_the_sample_is_the_captured_one(sample):
    assert sample["Gamma"].shape == (1, 225, 16383)
    assert sample["Gamma"].dtype == np.float32
    assert int(sample["iteration"]) == 73
    assert sample["samples"].tolist() == [22]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_both_packages_condition_the_sample(sample, dtype):
    """No breakdown in either package on the CPU: the moments are finite
    and agree."""
    args = _inputs(sample, dtype)
    eps = EPS[dtype]
    jm, jv = map(np.asarray, jvo.condition_ensemble(
        *map(jnp.asarray, args), eps=eps))
    tm, tv = (t.numpy() for t in tvo.condition_ensemble(
        *map(torch.as_tensor, args), eps=eps))
    for x in (jm, jv, tm, tv):
        assert np.isfinite(x).all()
    assert _rel(tm, jm) <= RTOL[dtype] and _rel(tv, jv) <= RTOL[dtype]


def test_an_f32_factorisation_breaks_down_by_rounding_alone(sample):
    """Positive definite in f64 (least eigenvalue above the 1e-6 of f32's
    jitter, condition below 1e7), but the JAX formula assembled in f32
    by numpy is indefinite, and both packages' Cholesky of it fail; the
    port's own f32 assembly of the same matrix lies further from it than
    the jitter."""
    G, _, _, P, v = _inputs(sample, np.float64)
    ev = np.linalg.eigvalsh(_operand(G[0], P[0], v, EPS[np.float64]))
    assert ev[0] > 1e-6 and ev[-1] / ev[0] < 1e7
    G, _, _, P, v = _inputs(sample, np.float32)
    op = _operand(G[0], P[0], v, EPS[np.float32])
    assert np.linalg.eigvalsh(op.astype(np.float64))[0] < 0
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(
        jnp.asarray(op)))).all()
    assert int(torch.linalg.cholesky_ex(torch.as_tensor(op))[1]) != 0
    Gt, Pt, vt = (torch.as_tensor(x) for x in (G, P, v))
    Lam = (Gt / Pt[:, None, :]) @ Gt.transpose(-1, -2) + torch.diag(vt)
    d = torch.sqrt(torch.diagonal(Lam[0]))
    port = (Lam[0] / d[:, None] / d[None, :]).numpy()
    assert np.abs(port + EPS[np.float32] * np.eye(len(d)) - op).max() \
        > EPS[np.float32]


def _ensembles(sample):
    """Both packages' constrain ensembles in f32 holding the sample's
    Gamma and alpha, before their first conditioning, with fixed vo_var."""
    tv = object.__new__(tvo.VirtualObservablesEnsemble)
    tv._fixed_precision = True
    jv = object.__new__(jvo.VirtualObservablesEnsemble)
    jv.infinite_precision_mask = jnp.ones(sample["Gamma"].shape[1], bool)
    for vo, dt, to in ((tv, torch.float32, torch.as_tensor),
                       (jv, jnp.float32, jnp.asarray)):
        vo.dtype, vo.N, vo.prior_precision_factor = dt, 1, 1.0
        vo._Gamma, vo._alpha, vo.vo_variances = (
            to(sample[k]) for k in ("Gamma", "alpha", "vo_var"))
        vo._mean = vo._vars = vo._fallback_mask = None
    return tv, jv


class _Writer:
    def __init__(self):
        self.logged = []

    def add_scalar(self, tag, value, global_step=None):
        self.logged.append((tag, int(value), global_step))


def test_both_packages_fall_back_to_the_prior_on_the_cards_failure(
        sample, monkeypatch):
    """The card's outcome replayed: the f32 factorisation fails (the
    port's ``cholesky_ex`` reports it, the JAX package's Cholesky gives
    NaN).  Both packages warn, log one failure at iteration 73, flag the
    sample for the next precision update and store its prior moments."""
    cholesky_ex = torch.linalg.cholesky_ex

    def failing_in_f32(A, **kw):
        L, info = cholesky_ex(A, **kw)
        return L, info + (A.dtype == torch.float32)

    def failing(*args, **kw):
        m, v = jvo_condition(*args, **kw)
        return m * jnp.nan, v * jnp.nan

    jvo_condition = jvo.condition_ensemble
    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing_in_f32)
    monkeypatch.setattr(jvo, "condition_ensemble", failing)
    G, PREC = sample["G"], sample["PREC"]
    stored = {}
    for name, vo, to in zip(("port", "jax"), _ensembles(sample),
                            (torch.as_tensor, jnp.asarray)):
        writer = _Writer()
        with pytest.warns(UserWarning, match="non-finite moments for 1/1 "
                          "samples at iteration 73"):
            vo.update(to(G), to(PREC), 73, writer=writer)
        assert writer.logged == [("Monitor/VO_conditioning_failures", 1, 73)]
        assert np.asarray(vo._fallback_mask).tolist() == [True]
        stored[name] = (np.asarray(vo.mean), np.asarray(vo.vars))
    for m, v in stored.values():
        assert m.dtype == np.float32
        np.testing.assert_array_equal(m, G)
        np.testing.assert_array_equal(v, np.maximum(1 / PREC, 1e-12))
