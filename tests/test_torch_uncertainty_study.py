"""BASELINE config 5's uncertainty sweep in the port
(``examples/torch_uncertainty_study.py``) against the JAX package's
(``examples/uncertainty_study.py``).

1. Solve and reduce: the same numpy fields (seeded normals) and Dirichlet
   values go through JAX's ``_get_run(phys, C, B)`` and the port's
   ``solve_qoi`` + ``qoi_moments`` at 16^2 (4 cases x B = 8, 'ND', Jacobi
   in both) and at 64^2 (2 cases x B = 4, f64, the multigrid V-cycle in
   both): mean, std, p5 and p95 agree to rtol 1e-8 in f64 and 1e-5 in
   f32 (two f32 PCGs to 2e-6 that sum in another order).
2. The field draw: with both packages' standard normals replaced by one
   numpy stream, the port's ``sample_fields`` equals the fields JAX's
   ``qoi_sweep`` hands its run (rtol 1e-6: JAX draws in f64 and rounds to
   f32), its Dirichlet values equal JAX's, and the whole sweep's moments
   agree to rtol 1e-5.
3. ``main`` writes the study file of the JAX example, which the JAX
   package's ``ParameterStudy`` loads.
"""

import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from generative_physics_informed_pde_tpu import fem as jfem
from generative_physics_informed_pde_tpu.utils import (
    ParameterStudy as JaxParameterStudy)
from generative_physics_informed_pde_tpu_torch import fem
from generative_physics_informed_pde_tpu_torch.fem import randomfield as trf

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
LENGTHS = (0.1, 0.2, 0.3, 0.4)
KEYS = ("mean", "std", "p5", "p95")


def _module(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these solves are many small ops, which slow
    down by tens of times when every test worker's threads contend for the
    cores; the results do not depend on the thread count here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def studies():
    return _module("uncertainty_study"), _module("torch_uncertainty_study")


def _physics(n):
    return (jfem.LinearEllipticPhysics("fom", "ND", jfem.StructuredTriGrid(n, n)),
            fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(n, n),
                                      device="cpu"))


@pytest.mark.parametrize("n,C,B,dtype,rtol", [
    (16, 4, 8, "float64", 1e-8), (16, 4, 8, "float32", 1e-5),
    (64, 2, 4, "float64", 1e-8)])
def test_solve_and_reduce_matches_jax(studies, n, C, B, dtype, rtol):
    jus, tus = studies
    jphys, tphys = _physics(n)
    mg = tphys._batched_solver.mg
    assert (mg is not None) == (n == 64)  # the 'auto' gate's V-cycle at 64^2
    rng = np.random.default_rng(n + C)
    fields = (0.4 + 0.8 * rng.standard_normal((C * B, n, n))).astype(dtype)
    bc = tus.centre_bc_values(tphys, C * B, getattr(torch, dtype))
    jbc = jphys.profile.constrained_values(
        jnp.tile(jnp.array([[0.0, 0.0, 1.0, 1.0]]), (C * B, 1)))
    np.testing.assert_array_equal(bc.double().numpy(),
                                  np.asarray(jbc).astype(dtype))
    want = jus._get_run(jphys, C, B)(jnp.asarray(fields),
                                     jnp.asarray(bc.numpy()))
    q = tus.solve_qoi(tphys, torch.as_tensor(fields), bc)
    got = tus.qoi_moments(q, C)
    assert q.shape == (C * B,) and q.dtype == getattr(torch, dtype)
    for k in KEYS:
        assert got[k].shape == (C,)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=rtol, err_msg=k)
    # informative, not degenerate: centre pressure ~ 0.5 for the 0 -> 1
    # profile (the JAX test's bounds)
    assert np.all(got["mean"].numpy() > 0.2)
    assert np.all(got["std"].numpy() > 0.0)
    assert np.all(got["p5"].numpy() < got["p95"].numpy())


def test_sample_fields_and_sweep_match_jax_under_injected_normals(
        studies, monkeypatch):
    jus, tus = studies
    C, B, n = len(LENGTHS), 8, 16
    jphys, tphys = _physics(n)
    seen = {}
    real = jus._get_run(jphys, C, B)

    def get_run(phys, C_, B_):
        assert (phys, C_, B_) == (jphys, C, B)

        def run(fields, bc_values):
            seen.update(fields=np.asarray(fields), bc=np.asarray(bc_values))
            return real(fields, bc_values)
        return run

    def inject(seed):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        monkeypatch.setattr(jax.random, "normal", lambda key, shape, *a, **k:
                            jnp.asarray(rj.standard_normal(shape)))
        monkeypatch.setattr(trf, "standard_normal",
                            lambda shape, generator, dtype, device:
                            torch.as_tensor(rt.standard_normal(shape),
                                            dtype=dtype, device=device))

    monkeypatch.setattr(jus, "_get_run", get_run)
    inject(3)
    want = jus.qoi_sweep(jphys, LENGTHS, B, n=n)
    got = tus.qoi_sweep(tphys, LENGTHS, B, n=n, device="cpu")
    assert seen["fields"].shape == (C * B, n, n)
    assert seen["fields"].dtype == np.float32
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    inject(3)
    fields = tus.sample_fields(LENGTHS, B, n=n, dtype=torch.float64,
                               device="cpu")
    np.testing.assert_allclose(fields.float().numpy(), seen["fields"],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tus.centre_bc_values(tphys, C * B, torch.float64).numpy(), seen["bc"])


def test_main_writes_the_jax_study_file(studies, tmp_path, monkeypatch):
    _, tus = studies
    monkeypatch.chdir(tmp_path)
    study = tus.main(["4"], device="cpu")
    assert [p.name for p in tmp_path.iterdir()] == [tus.STUDY_FILE]
    back = JaxParameterStudy.load(str(tmp_path / tus.STUDY_FILE))
    assert sorted(back.keys()) == [(4,), (8,), (16,), (32,)]
    for key in back.keys():
        (rec,) = back.get(key)
        assert rec == study.get(key)[0]
        assert 0.2 < rec["qoi_mean"] < 0.8 and rec["qoi_std"] > 0
        assert rec["qoi_p5"] < rec["qoi_p95"]
