"""The port's Gaussian random field (dense Cholesky path) against the JAX
package's: the points, the covariance and its Cholesky factor to 1e-10
(both numpy float64 on the host), and a sample with injected normals
(``gamma``) equal to the JAX sample to 1e-10 in f64.  The highres32 data
preset draws its unlabeled fields from it."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu.fem import randomfield as jrf
from generative_physics_informed_pde_tpu_torch.factories.data import (
    DataFactory)
from generative_physics_informed_pde_tpu_torch.fem import randomfield as trf


def _fields(n=12):
    args = dict(mean=0.4, stddev=0.8, corrlength=0.15)
    return (jrf.GaussianRandomField.from_image(n, n, **args),
            trf.GaussianRandomField.from_image(n, n, **args))


@pytest.mark.parametrize("kernel", ["se", "matern32"])
def test_covariance_and_factor_match_jax(kernel):
    X = jrf.pixel_center_points(7, 9)
    np.testing.assert_allclose(trf.pixel_center_points(7, 9), X,
                               rtol=1e-10, atol=1e-10)
    C = trf.stationary_covariance(X, 0.8, 0.15, kernel)
    np.testing.assert_allclose(
        C, jrf.stationary_covariance(X, 0.8, 0.15, kernel),
        rtol=1e-10, atol=1e-10)
    j, t = _fields()
    np.testing.assert_allclose(t._L("cpu").numpy(), j._L, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(trf.convert_log_mean_std(1.3, 0.4),
                               jrf.convert_log_mean_std(1.3, 0.4),
                               rtol=1e-12)


def test_sample_with_injected_normals_matches_jax():
    j, t = _fields()
    gamma = np.random.default_rng(0).standard_normal((5, t.dim_in))
    ref = np.asarray(j.sample(None, batch_size=5, gamma=jnp.asarray(gamma),
                              dtype=jnp.float64))
    got = t.sample(batch_size=5, gamma=torch.as_tensor(gamma),
                   dtype=torch.float64, device="cpu")
    assert got.shape == (5, 12, 12)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-10)


def test_sample_draws_from_the_generator():
    _, t = _fields()
    a = t.sample(torch.Generator().manual_seed(3), batch_size=4,
                 device="cpu", dtype=torch.float64)
    b = t.sample(torch.Generator().manual_seed(3), batch_size=4,
                 device="cpu", dtype=torch.float64)
    assert torch.equal(a, b) and a.shape == (4, 12, 12)
    assert t.sample(torch.Generator().manual_seed(3), device="cpu").shape \
        == (12, 12)
    # the Karhunen-Loeve path draws its dim_in normals from the generator
    kl = trf.GaussianRandomField.from_image(8, 8, 0.4, 0.8, 0.1,
                                            truncation="adaptive")
    x = kl.sample(torch.Generator().manual_seed(3), batch_size=2,
                  device="cpu", dtype=torch.float64)
    gamma = torch.randn((2, kl.dim_in), generator=torch.Generator(
        ).manual_seed(3), dtype=torch.float64)
    np.testing.assert_allclose(x.numpy(), kl.sample(
        batch_size=2, gamma=gamma, device="cpu", dtype=torch.float64).numpy(),
        rtol=1e-12)


def test_highres32_preset_pools():
    df = DataFactory.FromIdentifier("highres32")
    dl = df.labeled()
    assert dl.N == 1024 and dl.X.shape == (1024, 32, 32)
    dlu = df.unlabeled(6, torch.Generator().manual_seed(1), device="cpu")
    assert dlu.X.shape == (6, 32, 32) and np.isfinite(dlu.X).all()
    with pytest.raises(RuntimeError, match="locked"):
        dlu.assemble({})
