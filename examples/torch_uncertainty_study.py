#!/usr/bin/env python
"""Posterior-predictive uncertainty-propagation sweep (BASELINE config 5),
built from the PyTorch port.

For each of four correlation lengths, ``batch_per_case`` (4096) log-
conductivity fields of 64^2 are drawn from the port's FFT random field and
pushed through ONE flattened batched full-order Darcy solve of all the
systems (16,384: the multigrid V-cycle, whose sweeps and residuals run on
the stencil kernel K1); the pressure at the domain centre is read through
a QOI, and its mean, standard deviation and 5th / 95th percentiles per
case are collected into a ParameterStudy, saved to
``results_uncertainty_study.json`` in the working directory.  The port of
``examples/uncertainty_study.py``; its random draws are the port's own
(a ``torch.Generator`` on the device per case), not the JAX package's.

Run:  python examples/torch_uncertainty_study.py [batch_per_case] [--mesh N] [--cpu]

On the card by default; ``--cpu`` runs on the CPU.  ``--mesh N`` under
``torchrun --nproc-per-node N`` spreads the solve over the N processes
(gloo on the CPU, nccl on cards): each solves its contiguous share of the
systems, N must divide 4 * batch_per_case, and the QOI values are
gathered before the reduce.  Each process
then stops its PCG on its own systems' residuals, so the moments agree
with one process's to the solver's tolerance, not bit for bit.  From
Python, ``main(["8"], device="cpu")``.  Imports nothing of JAX.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from generative_physics_informed_pde_tpu_torch import fem  # noqa: E402
from generative_physics_informed_pde_tpu_torch import parallel  # noqa: E402
from generative_physics_informed_pde_tpu_torch.fem import QOI  # noqa: E402
from generative_physics_informed_pde_tpu_torch.parallel import (  # noqa: E402
    make_mesh)
from generative_physics_informed_pde_tpu_torch.utils import (  # noqa: E402
    ParameterStudy, StopWatch, resolve_device)

CORRLENGTHS = (0.04, 0.08, 0.16, 0.32)
STUDY_FILE = "results_uncertainty_study.json"
# The JAX example caches its jitted sweep bodies (_RUN_CACHE) so that a
# second sweep does not retrace; the port traces nothing, so has no cache.


def sample_fields(corrlengths, B, n=64, seed=0, dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """(C * B, n, n) log-conductivity fields, case-major: ``B`` per
    correlation length ``l`` from the FFT field of mean 0.4 and stddev
    0.8, drawn from a ``torch.Generator`` on ``device`` seeded
    ``seed + int(l * 1000)``."""
    device = resolve_device(device)
    fields = []
    for l in corrlengths:
        rf = fem.GaussianRandomField.from_image(
            n, n, mean=0.4, stddev=0.8, corrlength=l, method="fft")
        gen = torch.Generator(device=device).manual_seed(seed + int(l * 1000))
        fields.append(rf.sample(gen, batch_size=B, dtype=dtype,
                                device=device))
    return torch.cat(fields)


def centre_bc_values(phys, N: int, dtype=torch.float32) -> torch.Tensor:
    """(N, n_constrained) Dirichlet values of the 0 -> 1 left-to-right
    profile (theta = [0, 0, 1, 1]) for every system, on the physics'
    device."""
    theta = np.tile([[0.0, 0.0, 1.0, 1.0]], (N, 1))
    return torch.as_tensor(phys.profile.constrained_values(theta),
                           dtype=dtype, device=phys.device)


def solve_systems(phys, fields, bc_values):
    """``(alphas, Y)`` of the N fields: the DG0 conductivity (pixels ->
    DG0, ``exp``) and its restricted solutions, from one batched solve of
    all N systems."""
    alphas = torch.exp(phys.pixels.image_to_function(fields))
    return alphas, phys.solve_batched(alphas, bc_values)


def centre_qoi(phys, Y, bc_values) -> torch.Tensor:
    """(N,) pressure at the domain centre of the restricted solutions
    ``Y``, through the profile."""
    return QOI(phys.grid, mx=0.5, my=0.5).extract(
        Y, bc_values=bc_values, profile=phys.profile)


def solve_qoi(phys, fields, bc_values, mesh=None) -> torch.Tensor:
    """(N,) pressure at the domain centre of every field, from one
    batched solve of all N systems.  On a mesh of several processes each
    solves its ``local_shard_slice(N)`` (which raises unless the process
    count divides N) and the values are gathered, so every process
    returns all N."""
    split = mesh is not None and mesh.size() > 1
    if split:
        rows = parallel.local_shard_slice(fields.shape[0])
        fields, bc_values = fields[rows], bc_values[rows]
    _, Y = solve_systems(phys, fields, bc_values)
    q = centre_qoi(phys, Y, bc_values)
    return parallel.all_gather_rows(q) if split else q


def qoi_moments(q: torch.Tensor, C: int) -> dict:
    """Per-case moments of the case-major QOI values: mean, std (ddof 0,
    as ``jnp.std``) and the 5th / 95th percentiles (linear
    interpolation, as ``jnp.percentile``), each of shape (C,)."""
    q = q.reshape(C, -1)
    pct = torch.quantile(q, torch.tensor([0.05, 0.95], dtype=q.dtype,
                                         device=q.device), dim=1)
    return {"mean": q.mean(dim=1), "std": q.std(dim=1, correction=0),
            "p5": pct[0], "p95": pct[1]}


def qoi_sweep(phys, corrlengths, B, mesh=None, n=64, seed=0, device="cuda"):
    """Sample ``B`` fields per correlation length and run the whole sweep
    as ONE flattened batched solve of C*B systems; per-case QOI moments
    are reduced afterwards.  With a mesh of several processes the
    flattened solve batch is split over them, and their count must divide
    C*B (ValueError otherwise).

    Returns a dict of per-case QOI moments, each a tensor of
    ``len(corrlengths)`` on ``device``."""
    C = len(corrlengths)
    fields = sample_fields(corrlengths, B, n=n, seed=seed, device=device)
    bc_values = centre_bc_values(phys, C * B, fields.dtype)
    return qoi_moments(solve_qoi(phys, fields, bc_values, mesh), C)


def build_study(moments) -> ParameterStudy:
    """The study of the sweep's host moments (numpy arrays of
    ``len(CORRLENGTHS)``): one record per case, keyed by the correlation
    length in hundredths."""
    study = ParameterStudy([("corrlength_x100", int)])
    for i, l in enumerate(CORRLENGTHS):
        study.accumulate((int(l * 100),), {
            f"qoi_{k}": float(moments[k][i])
            for k in ("mean", "std", "p5", "p95")})
    return study


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else list(argv)
    n_mesh = None
    if "--mesh" in argv:
        i = argv.index("--mesh")
        n_mesh = int(argv[i + 1])
        del argv[i:i + 2]
    if "--cpu" in argv:
        device = "cpu"
    args = [a for a in argv if not a.startswith("--")]
    B = int(args[0]) if args else 4096
    n = 64
    if n_mesh:
        parallel.initialize(device=device)
    phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(n, n),
                                     device=device)
    mesh = make_mesh(n_mesh, device=device) if n_mesh else None

    # the outputs go to the host inside the timed region: the solve runs
    # asynchronously on a card
    sw = StopWatch(start=True)
    out = qoi_sweep(phys, CORRLENGTHS, B, mesh=mesh, n=n, device=device)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    dt = sw.stop()
    # steady-state rate (fresh fields)
    sw2 = StopWatch(start=True)
    out2 = qoi_sweep(phys, CORRLENGTHS, B, mesh=mesh, n=n, seed=1,
                     device=device)
    _ = {k: v.cpu().numpy() for k, v in out2.items()}
    dt2 = sw2.stop()

    study = build_study(out)
    for i, l in enumerate(CORRLENGTHS):
        print(f"l={l}: qoi = {out['mean'][i]:.4f} +- {out['std'][i]:.4f}"
              f"  [{out['p5'][i]:.4f}, {out['p95'][i]:.4f}]", flush=True)
    total_solves = B * len(CORRLENGTHS)
    print(f"{total_solves} batched {n}^2 solves on {phys.device} in "
          f"{dt:.1f}s (cold, first call) -> {total_solves / dt:.0f} "
          f"solves/s; warm: {dt2:.1f}s -> {total_solves / dt2:.0f} solves/s"
          + (f" (mesh dp={n_mesh})" if n_mesh else ""), flush=True)
    if parallel.process_index() == 0:
        study.save(STUDY_FILE)
        print(f"study saved to {STUDY_FILE}", flush=True)
    return study


if __name__ == "__main__":
    main()
