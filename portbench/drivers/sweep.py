"""Uncertainty sweeps back to back (BASELINE config 5), one client.

Set-up draws ``distinct_sweeps`` sweeps of fields (``fields_per_case`` per
correlation length, case-major) from ``--seed`` and the draw index, builds
the port's physics and warms the solve.  The window then runs sweeps in a
closed loop, sweep ``k`` on the fields of draw ``k mod distinct_sweeps``:
``examples/torch_uncertainty_study.py``'s ``solve_systems`` and
``centre_qoi`` (the body of its ``solve_qoi`` on one process) and
``qoi_moments``, each sweep ending with its moments on the host.  After the
window one sweep, drawn from the seed, is checked against the plain
reference solved in float64: every system's solution, every QOI and the
moments.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import fields
from portbench.reference import fem as ref

# K1 is the only kernel of the program on this path
K1_NAME = "apply_stencil_kernel"


def program(ctx):
    """(study module, physics) of the port on the context's device."""
    sys.path.insert(0, str(ctx.root / "examples"))
    import torch_uncertainty_study as tus
    from generative_physics_informed_pde_tpu_torch import fem

    if ctx.on_card:
        from generative_physics_informed_pde_tpu_torch.ops import _build

        _build.build_all(["stencil"])
    n = ctx.config["grid"]
    phys = fem.LinearEllipticPhysics("fom", ctx.config["physics_id"],
                                     fem.StructuredTriGrid(n, n),
                                     device=ctx.device)
    return tus, phys


def draw(ctx, k: int) -> torch.Tensor:
    """The fields of draw ``k``: (C * B, n, n), case-major."""
    c = ctx.config
    f = c["field"]
    dtype = getattr(torch, c["dtype"])
    return torch.cat([
        fields.sample(c["grid"], c["fields_per_case"], mean=f["mean"],
                      stddev=f["stddev"], corrlength=ell, kernel=f["kernel"],
                      gen=fields.generator(ctx.seed, k * 64 + i, ctx.device),
                      dtype=dtype)
        for i, ell in enumerate(c["corrlengths"])])


def reference_outputs(ctx, X: torch.Tensor, dtype) -> dict:
    """The plain reference's solutions (free nodes), QOIs and moments of
    the fields ``X``, solved in ``dtype`` in blocks."""
    tr = ctx.traffic["reference"]
    C = len(ctx.config["corrlengths"])
    theta = torch.tensor([[0.0, 0.0, 1.0, 1.0]], dtype=torch.float64)
    Y, q = [], []
    for lo in range(0, X.shape[0], tr["block"]):
        x = X[lo:lo + tr["block"]].to(dtype)
        f64 = dtype == torch.float64
        u, _ = ref.solve(x, theta.to(x.device, dtype).expand(x.shape[0], 4),
                         tol=tr["tol"] if f64 else tr["control_tol"],
                         maxiter=20000 if f64 else tr["control_maxiter"])
        Y.append(ref.free_values(u).double())
        q.append(ref.centre_value(u).double())
        del u
    q = torch.cat(q)
    return {"Y": torch.cat(Y), "q": q,
            "moments": ref.moments(q.cpu().numpy(), C)}


def compare(got: dict, want: dict) -> dict:
    """The numbers compared: the worst system's relative solution error,
    the worst QOI's absolute error and the worst moment's relative
    error."""
    Y, Yr = got["Y"].double(), want["Y"]
    sol = ((Y - Yr).norm(dim=1) / Yr.norm(dim=1)).max().item()
    qoi = (got["q"].double() - want["q"]).abs().max().item()
    mom = max(float(np.max(np.abs(np.asarray(got["moments"][k], np.float64)
                                  - want["moments"][k])
                           / np.maximum(np.abs(want["moments"][k]), 1e-12)))
              for k in want["moments"])
    return {"solution_rel_err": sol, "qoi_abs_err": qoi,
            "moments_rel_err": mom}


def run(ctx):
    c, tr = ctx.config, ctx.traffic
    C = len(c["corrlengths"])
    tus, phys = program(ctx)
    pool = [draw(ctx, k) for k in range(tr["distinct_sweeps"])]
    N = pool[0].shape[0]
    bc = tus.centre_bc_values(phys, N, pool[0].dtype)
    checked = int(np.random.default_rng(ctx.seed).integers(
        tr["checked_sweep_below"]))

    def sweep(X):
        _, Y = tus.solve_systems(phys, X, bc)
        q = tus.centre_qoi(phys, Y, bc)
        m = {k: v.cpu().numpy() for k, v in tus.qoi_moments(q, C).items()}
        return Y, q, m

    for k in range(tr["warmup_sweeps"]):
        sweep(pool[k % len(pool)])
    ctx.start_window()
    t_start = time.perf_counter()
    lat, its, kept, bad = [], [], None, 0
    k = 0
    while True:
        t0 = time.perf_counter()
        Y, q, m = sweep(pool[k % len(pool)])
        lat.append(time.perf_counter() - t0)
        its.append(int(phys.last_iterations))
        if not all(np.isfinite(v).all() for v in m.values()):
            bad += 1
        if k == checked:
            kept = (k, Y, q, m)
        del Y, q
        k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window = time.perf_counter() - t_start
    peak = ctx.window_peak()
    if kept is None:  # a window too short for the drawn sweep: the last
        kept = (k - 1, *sweep(pool[(k - 1) % len(pool)]))
    ctx.attempted, ctx.failed = k, bad
    ctx.e2e = {"sweep_solves_per_s": k * N / window,
               "sweep_ms_p90": 1e3 * float(np.percentile(lat, 90))}
    ctx.counters = {"pcg_iterations": its, "sweeps": k, "window_s": window,
                    "systems": N, "window_peak_bytes": peak,
                    "bytes_per_sweep": N * 4 * (
                        7 * (c["grid"] + 1) ** 2 + c["grid"] ** 2
                        + (c["grid"] + 1) ** 2)}

    if ctx.trace:
        n_tr = tr["traced_iterations"]

        def traced():
            for j in range(n_tr):
                sweep(pool[j % len(pool)])

        ctx.profile(traced, n_tr)
        ctx.counters["k1_name"] = K1_NAME
        if ctx.on_card:
            ctx.counters["k1_clean_ms"] = k1_clean_ms(ctx, phys, N)

    j, Y, q, m = kept
    got = {"Y": Y, "q": q, "moments": m}
    X = pool[j % len(pool)]
    del pool
    want = reference_outputs(ctx, X, torch.float64)
    for name, value in compare(got, want).items():
        ctx.check(name, value, tr["limits"][name])
    ctx.kept = {"X": X, "want": want, "physics": phys, "study": tus}


def control(ctx) -> dict:
    """The numbers of the control: the plain reference in the program's
    place, solved in bfloat16 (the precision below the configuration's
    float32), on the checked sweep's fields."""
    k = ctx.kept
    got = reference_outputs(ctx, k["X"], torch.bfloat16)
    return compare(got, k["want"])


def _bf16_vcycle(ctx) -> dict:
    """The numbers of the program with its own bfloat16 V-cycle
    (``precond_dtype="bfloat16"``; the outer PCG stays float32)."""
    from generative_physics_informed_pde_tpu_torch.fem.batched_solver import (
        make_batched_fom_solver)

    k = ctx.kept
    phys, tus = k["physics"], k["study"]
    phys.__dict__["_batched_solver"] = make_batched_fom_solver(
        phys.op, phys.profile, precond="mg", precond_dtype="bfloat16")
    C = len(ctx.config["corrlengths"])
    X = k["X"]
    bc = tus.centre_bc_values(phys, X.shape[0], X.dtype)
    _, Y = tus.solve_systems(phys, X, bc)
    q = tus.centre_qoi(phys, Y, bc)
    m = {n: v.cpu().numpy() for n, v in tus.qoi_moments(q, C).items()}
    return compare({"Y": Y, "q": q, "moments": m}, k["want"])


program_variants = {"program_bf16_vcycle": _bf16_vcycle}


def k1_clean_ms(ctx, phys, N) -> float:
    """K1 through the port's ``apply_stencil`` at the sweep's finest
    shape, by CUDA events with a clean L2 (a 256 MB read between calls)."""
    from generative_physics_informed_pde_tpu_torch.ops import apply_stencil
    from portbench.measure import cuda_time_ms

    n = ctx.config["grid"] + 1
    gen = fields.generator(ctx.seed, 10 ** 6, ctx.device)
    dtype = getattr(torch, ctx.config["dtype"])
    coefs = torch.rand((7, n, n, N), generator=gen, device=ctx.device,
                       dtype=dtype) + 0.5
    v = torch.randn((n, n, N), generator=gen, device=ctx.device, dtype=dtype)
    mask = torch.ones((n, n, 1), device=ctx.device, dtype=dtype)
    mask[:, 0] = 0
    mask[:, -1] = 0
    flush = torch.empty(2 ** 26, device=ctx.device, dtype=torch.float32)
    flush.zero_()
    t = cuda_time_ms(lambda: apply_stencil(coefs, v, mask), 50, flush.sum)
    del coefs, v, mask, flush
    return t
