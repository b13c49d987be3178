#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's highres32 slice the way a user does: label the 1024
fields of ``cdata/highres32.labeled.npz`` (read-only) through the batched
Jacobi-PCG solve, whose stencil applies run on the hand-written CUDA kernel
``ops/csrc/stencil.cu``, then answer requests with the surrogate through
pad-to-bucket ``SurrogateBundle.predict``.  The kernel is built from the
sources (``nvcc`` into ``build/torch_kernels/``) and held against its plain
PyTorch version on the card; the labels are checked against residuals
recomputed with the plain apply, an f64 solve and a dense direct solve.
Every phase raises on failure, so the script exits non-zero and never
prints its last line.  Imports torch, numpy, the standard library and the
port only.

Output: progress lines, the card's name and power limit as nvidia-smi
prints them, one ``{"kernels": [...]}`` line with each kernel's launches on
the main path, error against its plain version and times, and as the last
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LABELED = ROOT / "cdata" / "highres32.labeled.npz"

# Kernel vs plain version, max |diff| / max |plain|.  The kernel does the
# same products and sums in the same order without fused multiply-adds, so
# it is expected to agree exactly; the bounds are a few ulps of each type.
KERNEL_RTOL = {"float32": 1e-6, "float64": 1e-12}
# PCG tolerances of the reference (batched_solver.py:284-285).
TOL_F32, TOL_F64 = 2e-6, 1e-10
# An f32 PCG's recursive residual reaches 2e-6, but its true residual
# stalls at the f32 rounding floor: about 2e-5 at most over this pool on
# an H100.  The f32 labels are therefore held to 1e-4 on
# the true residual and on the distance to the f64 labels; the f64 solve is
# held to its own tolerance on the true residual.
F32_FLOOR = 1e-4
# Kernel-path vs plain-path solve on the card, max |diff| / max |Y|
# (both f32; identical applies give identical iterates).
PATH_RTOL = 1e-6
# f64 labels vs a dense direct solve (numpy, f64).
DIRECT_RTOL = 1e-8
# Served batch vs the module called on the exact batch (f32; the padded
# bucket may pick other conv algorithms).
SERVE_RTOL = 1e-4

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores

REQUEST_SIZES = (1, 7, 64, 300, 1024)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events, after 3 warm-up calls.

    With ``flush`` (a tensor larger than the 50 MB L2) each call is timed
    alone, after the L2 cache was overwritten outside the timed interval,
    so it reads from HBM.  Without, ``reps`` calls run back to back behind
    a device-side sleep that lets the host enqueue them all first, so host
    launch overhead is not in the time."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: (device busy ms, wall ms,
    [(kernel name, ms, calls)] largest first).  Busy time is the sum of
    kernel times; kernels of one stream do not overlap."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    kernels = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (ms + ev.device_time / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in kernels.items()),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows


def stencil_inputs(op, profile, B, dtype, gen):
    import torch

    grid = op.grid
    Ny, Nx = grid.ny + 1, grid.nx + 1
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=gen,
                                   dtype=torch.float64)).to(dtype).cuda()
    coefs = op.coefficients(alphas).permute(1, 2, 3, 0).contiguous()
    v = torch.randn(Ny, Nx, B, generator=gen, dtype=torch.float64
                    ).to(dtype).cuda()
    mask = torch.as_tensor(profile.free_mask.reshape(Ny, Nx, 1),
                           dtype=dtype).cuda()
    return coefs, v, mask


def true_residual(fom, Y, alphas, vals, apply_plain):
    """Per-sample ||mask * K(alpha) y_full|| / ||mask * K(alpha) bc||,
    in f64 with the plain apply."""
    import torch

    dt = torch.float64
    B = alphas.shape[0]
    Ny, Nx = fom.grid.ny + 1, fom.grid.nx + 1
    con = torch.as_tensor(fom.constrained_dofs, device=alphas.device)
    free = torch.as_tensor(fom.free_dofs, device=alphas.device)
    bc = torch.zeros(B, Ny * Nx, dtype=dt, device=alphas.device)
    bc[:, con] = vals.to(dt)
    full = bc.clone()
    full[:, free] = Y.to(dt)
    coefs = fom.op.coefficients(alphas.to(dt)).permute(1, 2, 3, 0).contiguous()
    mask = torch.as_tensor(fom.profile.free_mask.reshape(Ny, Nx, 1),
                           dtype=dt, device=alphas.device)

    def grids(f):
        return f.reshape(B, Ny, Nx).permute(1, 2, 0).contiguous()

    r = apply_plain(coefs, grids(full), mask)
    b = apply_plain(coefs, grids(bc), mask)
    return r.square().sum((0, 1)).sqrt() / b.square().sum((0, 1)).sqrt()


class plain_applies:
    """Route the batched solver's stencil applies through the plain
    PyTorch version for the duration of a ``with`` block."""

    def __enter__(self):
        from generative_physics_informed_pde_tpu_torch.fem import \
            batched_solver
        from generative_physics_informed_pde_tpu_torch.ops import \
            apply_stencil_reference

        self.mod = batched_solver
        self.saved = batched_solver.apply_stencil
        batched_solver.apply_stencil = apply_stencil_reference
        return self

    def __exit__(self, *exc):
        self.mod.apply_stencil = self.saved


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    import numpy as np

    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.factories import highres32
    from generative_physics_informed_pde_tpu_torch.ops import (
        _build, apply_stencil, apply_stencil_reference)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)

    # cuDNN convolutions default to TF32, which keeps ~3 decimal digits and
    # would loosen the encoder; matmuls are full f32 by default.  Both off.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()

    # ---------------------------------------------------- 1. device, build
    say("phase 1: device check and kernel build")
    card = card_line()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    report = _build.build_all()
    for name, r in report.items():
        say(f"built {name} in {r['seconds']:.2f} s"
            f"{' (cached)' if r['cached'] else ''}")
        for line in r["log"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")

    # ------------------------------------- 2. K1 against its plain version
    say("phase 2: apply_stencil kernel vs its plain version on the card")
    gen = torch.Generator().manual_seed(0)
    g33 = fem.StructuredTriGrid(32, 32)
    g9 = fem.StructuredTriGrid(8, 8)
    worst_abs = worst_rel = 0.0
    for grid, B, dtype in ((g33, 1024, torch.float32),
                           (g33, 1024, torch.float64),
                           (g9, 11, torch.float32)):
        coefs, v, mask = stencil_inputs(fem.StencilOperator(grid),
                                        fem.DirichletProfile(grid), B,
                                        dtype, gen)
        got = apply_stencil(coefs, v, mask)
        ref = apply_stencil_reference(coefs, v, mask)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        rel_err = abs_err / ref.abs().max().item()
        tol = KERNEL_RTOL[str(dtype).split(".")[-1]]
        say(f"  {tuple(v.shape)} {dtype}: max abs err {abs_err:.3e}, "
            f"max rel err {rel_err:.3e} (tolerance {tol:g} relative)")
        if not rel_err <= tol:
            raise AssertionError(f"apply_stencil disagrees with its plain "
                                 f"version at {tuple(v.shape)} {dtype}")
        worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel,
                                                            rel_err)

    # -------------------------------- 3+4. main path: label pool, serving
    say("phase 3: label the highres32 pool (1024 fields) through the kernel")
    with np.load(LABELED) as data:
        X = np.array(data["X"])
    if X.shape != (1024, 32, 32):
        raise AssertionError(f"{LABELED.name} holds X {X.shape}")
    N = X.shape[0]
    physics, _, dm, _, _ = highres32().setup(
        device="cuda", generator=torch.Generator().manual_seed(0))
    fom = physics["fom"]
    bce = fem.BoundaryConditionEnsemble.from_factory(
        "NDP", N, np.random.default_rng(0))
    bce.register_function_space("fom", fom.grid)
    bce.register_function_space("rom", physics["rom"].grid)
    F_rom = np.array(bce.full_f_with_applied_bc("rom"))

    apply_stencil.launches = 0  # counts from here cover the main path only
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.as_tensor(X, dtype=torch.float32, device="cuda")
    alphas = torch.exp(fom.pixels.image_to_function(x))
    vals = torch.as_tensor(bce.constrained_values("fom"),
                           dtype=torch.float32, device="cuda")
    Y = fom.solve_batched(alphas, vals)
    torch.cuda.synchronize()
    label_ms_first = 1e3 * (time.perf_counter() - t0)
    iters = fom.last_iterations
    label_launches = apply_stencil.launches
    say(f"  labels {tuple(Y.shape)} in {label_ms_first:.1f} ms, "
        f"{iters} PCG iterations, {label_launches} kernel launches")

    say("phase 4: serve requests through SurrogateBundle.predict")
    bundle = SurrogateBundle.build(dm, (32, 32), F_rom.shape[1],
                                   device="cuda")
    served = {}
    for n in REQUEST_SIZES:
        served[n] = bundle.predict(X[:n], F_rom[:n])
    torch.cuda.synchronize()
    main_launches = apply_stencil.launches

    # ------------------------------------------------ checks of the output
    say("checks: labels")
    if label_launches != iters + 1:
        raise AssertionError(f"{label_launches} launches for {iters} "
                             "iterations (expected one rhs apply + one "
                             "matvec per iteration)")
    if main_launches == 0:
        raise AssertionError("the main path launched apply_stencil 0 times")
    if Y.shape != (N, fom.dim_out) or not bool(torch.isfinite(Y).all()):
        raise AssertionError("labels are not finite of shape "
                             f"{(N, fom.dim_out)}")
    if not 0 < iters < fom._batched_solver.maxiter:
        raise AssertionError(f"PCG ran {iters} iterations")
    res32 = true_residual(fom, Y, alphas, vals, apply_stencil_reference)
    say(f"  f32 labels: true relative residual max {res32.max().item():.3e}"
        f" (f32 floor bound {F32_FLOOR:g}; PCG tol {TOL_F32:g})")
    if not bool((res32 <= F32_FLOOR).all()):
        raise AssertionError("f32 labels above the f32 residual floor")

    alphas64 = torch.exp(fom.pixels.image_to_function(
        torch.as_tensor(X, device="cuda")))
    vals64 = torch.as_tensor(bce.constrained_values("fom"), device="cuda")
    Y64 = fom.solve_batched(alphas64, vals64)
    iters64 = fom.last_iterations
    res64 = true_residual(fom, Y64, alphas64, vals64, apply_stencil_reference)
    say(f"  f64 labels ({iters64} iterations): true relative residual max "
        f"{res64.max().item():.3e} (tolerance {TOL_F64:g})")
    if not bool((res64 <= TOL_F64).all()):
        raise AssertionError("an f64 label's residual exceeds the tolerance")
    rel32 = ((Y.double() - Y64).norm(dim=1) / Y64.norm(dim=1)).max().item()
    say(f"  f32 vs f64 labels: rel-L2 max {rel32:.3e} (bound {F32_FLOOR:g})")
    if not rel32 <= F32_FLOOR:
        raise AssertionError("f32 labels far from the f64 labels")
    for i in (0, 1, 511, 1023):
        direct = fom.solve_direct(alphas64[i].cpu().numpy(),
                                  vals64[i].cpu().numpy())
        err = np.abs(Y64[i].cpu().numpy() - direct).max() / np.abs(
            direct).max()
        if not err <= DIRECT_RTOL:
            raise AssertionError(f"sample {i}: f64 label vs dense direct "
                                 f"solve {err:.3e}")
    say(f"  f64 labels agree with the dense direct solve on 4 samples "
        f"(tolerance {DIRECT_RTOL:g})")
    with plain_applies():
        before = apply_stencil.launches
        Y_plain = fom.solve_batched(alphas, vals)
        if apply_stencil.launches != before:
            raise AssertionError("the plain-path solve launched the kernel")
    path_err = ((Y - Y_plain).abs().max() / Y_plain.abs().max()).item()
    say(f"  kernel-path vs plain-path labels: max rel diff {path_err:.3e} "
        f"(tolerance {PATH_RTOL:g})")
    if not path_err <= PATH_RTOL:
        raise AssertionError("kernel-path labels differ from plain-path")

    say("checks: serving")
    F_dev = torch.as_tensor(F_rom, dtype=torch.float32, device="cuda")
    for n, y in served.items():
        if y.shape != (n, fom.dim_out) or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"request of {n}: output {tuple(y.shape)} "
                                 "not finite of the expected shape")
        rel = ((y - Y[:n]).norm(dim=1) / Y[:n].norm(dim=1)).mean().item()
        say(f"  request {n}: {tuple(y.shape)} finite, rel-L2 vs labels "
            f"{rel:.4f} (untrained weights)")
    direct7 = dm(x[:7], F_dev[:7])
    serve_err = ((served[7] - direct7).abs().max()
                 / direct7.abs().max()).item()
    say(f"  padded request of 7 vs the module on 7: {serve_err:.3e} "
        f"(tolerance {SERVE_RTOL:g})")
    if not serve_err <= SERVE_RTOL:
        raise AssertionError("bucket padding changed the prediction")

    # ----------------------------------------------------------- 5. times
    say("phase 5: timings (CUDA events, after warm-up)")
    coefs, v, mask = stencil_inputs(fem.StencilOperator(g33),
                                    fem.DirichletProfile(g33), 1024,
                                    torch.float32, gen)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    launches_before = apply_stencil.launches
    k_ms = cuda_time_ms(lambda: apply_stencil(coefs, v, mask), 100, flush)
    k_ms_warm = cuda_time_ms(lambda: apply_stencil(coefs, v, mask), 200)
    p_ms = cuda_time_ms(lambda: apply_stencil_reference(coefs, v, mask),
                        100, flush)
    p_ms_warm = cuda_time_ms(
        lambda: apply_stencil_reference(coefs, v, mask), 200)
    apply_stencil.launches = launches_before
    Ny, Nx, B = v.shape
    item = v.element_size()
    moved = (7 + 1 + 1) * Ny * Nx * B * item + Ny * Nx * item
    flops = 14 * Ny * Nx * B  # 7 mul, 6 add, 1 mask mul per output
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"  apply_stencil {tuple(v.shape)} f32: {k_ms * 1e3:.2f} us "
        f"(L2 flushed), {k_ms_warm * 1e3:.2f} us (L2 warm); plain "
        f"{p_ms * 1e3:.2f} / {p_ms_warm * 1e3:.2f} us; bound "
        f"{bound_ms * 1e3:.2f} us by {bound_by} ({moved / 1e6:.1f} MB)")
    say(f"  launches per label solve: {iters + 1} "
        f"(1 rhs + {iters} PCG iterations)")

    label_runs = []
    for _ in range(3):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fom.solve_batched(alphas, vals)
        e.record()
        torch.cuda.synchronize()
        label_runs.append(s.elapsed_time(e))
    apply_stencil.launches = launches_before
    label_ms = sorted(label_runs)[1]
    say(f"  label solve, 1024 fields f32: {label_ms:.2f} ms median of 3 "
        f"(first run {label_ms_first:.2f} ms host clock), {iters} iterations")
    busy, wall, rows = device_profile(lambda: fom.solve_batched(alphas, vals))
    apply_stencil.launches = launches_before
    if rows:
        say(f"  profiled label solve: device busy {busy:.2f} ms of "
            f"{wall:.2f} ms wall ({100 * busy / wall:.1f}%)")
        for name, ms, n in rows[:8]:
            say(f"    {ms:8.3f} ms {n:5d}x {name[:90]}")
    else:
        say("  profiled label solve: the profiler saw no device kernels "
            "(device busy share not measured)")

    predict_ms = {}
    for b in bundle.buckets:
        xb = x[:b].contiguous()
        fb = F_dev[:b].contiguous()
        predict_ms[b] = cuda_time_ms(lambda: bundle.predict(xb, fb), 20)
        say(f"  predict bucket {b}: {predict_ms[b]:.3f} ms")
    say(f"  card: {card}")

    # --------------------------------------------------------- 6. records
    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    kernels = {"kernels": [{
        "name": "apply_stencil",
        "route": "cuda",
        "source": "generative_physics_informed_pde_tpu_torch/ops/csrc/"
                  "stencil.cu",
        "replaces": "generative_physics_informed_pde_tpu/ops/stencil.py:32",
        "tpu": "ops/stencil.py:_make_kernel",
        "launches": main_launches,
        "max_abs_err": worst_abs,
        "max_rel_err": worst_rel,
        "ms": k_ms,
        "ms_l2_warm": k_ms_warm,
        "plain_ms": p_ms,
        "plain_ms_l2_warm": p_ms_warm,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "launches_per_label_solve": iters + 1,
        "label_solve_ms": label_ms,
        "predict_ms": {str(b): t for b, t in predict_ms.items()},
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
