"""The plain references agree with the port at small sizes on the CPU
(float64 where the port solves to 1e-10)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import fields
from portbench.reference import fem as ref
from portbench.reference import vae


@pytest.mark.parametrize("n,family", [(32, "NDP"), (64, "ND")])
def test_solve_matches_the_port(n, family):
    from generative_physics_informed_pde_tpu_torch import fem

    X = fields.sample(n, 6, mean=0.4, stddev=0.8, corrlength=0.08,
                      kernel="se", gen=fields.generator(3, n, "cpu"),
                      dtype=torch.float64)
    phys = fem.LinearEllipticPhysics("fom", family, fem.StructuredTriGrid(
        n, n), device="cpu")
    theta = (ref.ndp_thetas(X.numpy()) if family == "NDP"
             else np.tile([0.0, 0.0, 1.0, 1.0], (6, 1)))
    vals = torch.as_tensor(phys.profile.constrained_values(theta))
    Y = phys.solve_batched(torch.exp(phys.pixels.image_to_function(X)), vals)
    u, _ = ref.solve(X, torch.as_tensor(theta), tol=1e-12)
    Yr = ref.free_values(u)
    assert ((Y - Yr).norm(dim=1) / Yr.norm(dim=1)).max() < 1e-9
    q = fem.QOI(phys.grid).extract(Y, bc_values=vals, profile=phys.profile)
    assert (q - ref.centre_value(u)).abs().max() < 1e-9
    assert np.array_equal(phys.pixels.image_to_function(X).numpy(),
                          ref.cell_values(X.numpy()))


def test_coarse_operators_match_the_port():
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.fem.assembly import (
        assembly_tensor)
    from generative_physics_informed_pde_tpu_torch.fem.interpolation import (
        physics_resolution_interpolator)
    from generative_physics_informed_pde_tpu_torch.fem.solvers import (
        rom_solve)

    coarse = fem.StructuredTriGrid(8, 8)
    M = assembly_tensor(coarse)
    assert np.abs(M - ref.assembly_tensor(8)).max() < 1e-12
    fine = coarse.refined(3)
    W = physics_resolution_interpolator(
        coarse, fine, free_dofs=fem.DirichletProfile(fine).free_dofs)
    assert np.abs(W - ref.interpolation_matrix(8, 64)).max() < 1e-9
    th = np.random.default_rng(0).uniform(-0.5, 0.5, (5, 4))
    bce = fem.BoundaryConditionEnsemble("NDP", th)
    bce.register_function_space("rom", coarse)
    F = ref.rom_force(th, 8)
    assert np.abs(bce.full_f_with_applied_bc("rom") - F).max() < 1e-15
    a = torch.rand(5, 128, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(0)) + 0.5
    y = rom_solve(torch.as_tensor(M), a, torch.as_tensor(F),
                  fem.DirichletProfile(coarse).constrained_dofs)
    yr = ref.rom_solve(torch.as_tensor(ref.assembly_tensor(8)), a,
                       torch.as_tensor(F), 8)
    assert (y - yr).abs().max() < 1e-12


def test_moments_match_the_study():
    import sys

    from portbench.tests.tiny import ROOT

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_uncertainty_study as tus

    q = torch.randn(4 * 50, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = tus.qoi_moments(q, 4)
    want = ref.moments(q.numpy(), 4)
    for k in want:
        assert np.abs(got[k].numpy() - want[k]).max() < 1e-12


def test_parameter_names_and_shapes_match_the_port():
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres128)
    from portbench.tests.tiny import _config3_32

    m = _config3_32()["model"]
    _, model, _, _, _ = highres128(nx_rom=4, ny_rom=4,
                                   num_refines=3).setup(device="cpu")
    model.init_params({"supervised": {"X": torch.zeros(8, 32, 32)}})
    got = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert got == {k: tuple(s) for k, s, _ in vae.param_spec(m, 8)}
