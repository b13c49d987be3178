"""The port's Karhunen-Loeve and FFT circulant random-field paths against
the JAX package's.

KL (the 'highres' data preset's path, here on small grids): the adaptive
truncation keeps as many modes as JAX's, ``L L^T`` equals JAX's to 1e-10,
and a sample from injected normals equals JAX's.  ``eigh`` fixes neither
the sign of an eigenvector nor the basis of a repeated eigenvalue's space
(a square grid has many; the fixed 7-mode cut runs on a 10 x 13 grid,
whose 7th and 8th eigenvalues differ), so the factors are compared through
``L L^T``, and the samples through the orthogonal map ``Q`` with
``L_port = L_jax Q``: the port's sample from ``gamma`` equals JAX's from
``Q gamma`` (1e-10).

FFT: the embedded spectrum's square root equals JAX's to 1e-12 (both
numpy float64), and a sample equals JAX's when both packages draw the same
real-then-imaginary normals (``jax.random.normal`` and the port's
``randomfield.standard_normal`` replaced, 1e-10 in f64).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.fem import randomfield as jrf
from generative_physics_informed_pde_tpu_torch.fem import randomfield as trf

F64 = dict(dtype=torch.float64, device="cpu")


def _pair(*args, **kw):
    return (jrf.GaussianRandomField.from_image(*args, **kw),
            trf.GaussianRandomField.from_image(*args, **kw))


@pytest.mark.parametrize("py,px,corr,trunc", [
    (12, 12, 0.15, "adaptive"), (9, 14, 0.1, 0.999), (10, 13, 0.2, 7)])
def test_kl_factor_and_samples_match_jax(py, px, corr, trunc):
    j, t = _pair(py, px, 0.4, 0.8, corr, truncation=trunc)
    assert t._resolved_method == j._resolved_method == "kl"
    Lj = np.asarray(j._L)
    Lt = t._L("cpu").numpy()
    assert Lt.shape == Lj.shape and t.dim_in == j.dim_in == Lj.shape[1]
    assert 1 <= t.dim_in < t.dim_out
    np.testing.assert_allclose(t.eigvals, j.eigvals, rtol=1e-10,
                               atol=1e-12 * j.eigvals[0])
    np.testing.assert_allclose(Lt @ Lt.T, Lj @ Lj.T, rtol=1e-10, atol=1e-10)
    Q = np.linalg.lstsq(Lj, Lt, rcond=None)[0]
    np.testing.assert_allclose(Q.T @ Q, np.eye(Q.shape[0]), atol=1e-8)
    gamma = np.random.default_rng(1).standard_normal((5, t.dim_in))
    got = t.sample(batch_size=5, gamma=torch.as_tensor(gamma), **F64)
    want = np.asarray(j.sample(None, batch_size=5,
                               gamma=jnp.asarray(gamma @ Q.T),
                               dtype=jnp.float64))
    assert got.shape == (5, py, px)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


def test_kl_truncation_checks():
    with pytest.raises(ValueError):
        trf.GaussianRandomField.from_image(6, 6, 0.4, 0.8, 0.1,
                                           truncation="all")._L("cpu")
    with pytest.raises(ValueError):
        trf.GaussianRandomField.from_image(6, 6, 0.4, 0.8, 0.1,
                                           truncation=36)._L("cpu")
    # a near-constant field keeps at least one mode
    t = trf.GaussianRandomField.from_image(6, 6, 0.4, 0.8, 50.0,
                                           truncation="adaptive")
    assert t.dim_in == 1


@pytest.mark.parametrize("py,px", [(16, 16), (12, 20)])
def test_fft_factor_and_samples_match_jax(py, px, monkeypatch):
    j, t = _pair(py, px, 0.4, 0.8, 0.04, method="fft")
    np.testing.assert_allclose(t._fft_factor, j._fft_factor, rtol=1e-12,
                               atol=1e-12)
    assert t.dim_in == j.dim_in == 2 * 4 * py * px
    assert t.max_sample_batch == j.max_sample_batch  # the x64 widths
    rj, rt = np.random.default_rng(7), np.random.default_rng(7)
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k:
                        jnp.asarray(rj.standard_normal(shape)))
    monkeypatch.setattr(trf, "standard_normal",
                        lambda shape, generator, dtype, device:
                        torch.as_tensor(rt.standard_normal(shape),
                                        dtype=dtype, device=device))
    want = np.asarray(j.sample(jax.random.PRNGKey(0), batch_size=3,
                               dtype=jnp.float64))
    got = t.sample(None, batch_size=3, **F64)
    assert got.shape == (3, py, px)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="gamma"):
        t.sample(batch_size=1, gamma=torch.zeros(1, t.dim_in), **F64)


def test_fft_path_choice_and_warning():
    assert trf.GaussianRandomField.from_image(
        91, 91, 0.4, 0.8, 0.04)._resolved_method == "fft"  # > 8192 points
    assert trf.GaussianRandomField.from_image(
        8, 8, 0.4, 0.8, 0.04)._resolved_method == "cholesky"
    with pytest.raises(ValueError, match="pixel grid"):
        trf.GaussianRandomField(0.4, 0.8, 0.1, np.zeros((4, 2)),
                                method="fft")
    j, t = _pair(8, 8, 0.4, 0.8, 0.6, method="fft")
    with pytest.warns(UserWarning, match="negative spectrum"):
        j._fft_factor
    with pytest.warns(UserWarning, match="negative spectrum"):
        t._fft_factor
    a = t.sample(torch.Generator().manual_seed(2), batch_size=2, **F64)
    b = t.sample(torch.Generator().manual_seed(2), batch_size=2, **F64)
    assert torch.equal(a, b)
