#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's highres32 paths the way a user does: label the 1024
fields of ``cdata/highres32.labeled.npz`` (read-only) through the batched
Jacobi-PCG solve on the hand-written CUDA kernel ``ops/csrc/stencil.cu``
(K1), answer requests with the surrogate through pad-to-bucket
``SurrogateBundle.predict``, label the same pool with the symmetric 4-grid
solve on ``ops/csrc/stencil_sym.cu`` (K2), differentiate the solve through
its implicit-function VJP in both forms, and train the highres32 recipe
for 200 SVI steps (128 labeled pairs labeled through K1, 1024 unlabeled
fields from the port's random field, normals drawn on the host from a
seeded generator and coloured on the card), then serve the
trained surrogate.  Then the same recipe with virtual observables
(``examples/train_highres32.py --vo``: 128 VO fields from the labeled pool,
the constrain spec CGR + flux + 8 Gaussian + 8 RBF test functions), whose
constraint assembly runs K1 once per test column over the 128 fields, for
200 SVI steps with three refreshes, and one update of the energy arm,
whose subspace iteration runs on K1 too.  Then the halo-padded symmetric apply
``ops/csrc/stencil_sym_blocked.cu`` (K3) is held bit for bit against its
plain version and K2 and timed beside K2 at the padded shapes the JAX
package's roofline benchmark chains it at, and runs chained in its own
layout.  Then the 'highres' 64^2
recipe: label the preset's 2048 fields (Karhunen-Loeve draws, eigh on the
card) with the multigrid-preconditioned solve, whose V-cycle sweeps and
residuals all run on K1, in f32 and f64; differentiate that solve; and
train the recipe of ``bench.py`` (FFT fields, channel dropout 0.2) for 200
SVI steps.  Last, K1 and K2 run at every shape the main paths launched
them at, each held bit for bit against its plain version and timed, with
its launches derived from the paths' iteration counts (and checked against
the counted launches), and K3's launches per shape outside its chain are
read from the same counts.  All three kernels are built from the sources
(``nvcc`` into ``build/torch_kernels/``) and held against their plain
PyTorch versions on the card; the labels are checked against residuals
recomputed with the plain apply, f64 solves and a dense direct solve, the
gradients against the plain path, a Jacobi-preconditioned solve and
finite differences, the training against the recipe's expectations
and CPU runs of three f64 steps with the same draws (dropout masks
included), the virtual observables' stencil applies against the plain
path, their constraints against the labels, and a refresh and three f64
steps across one against the CPU.  Every phase raises
on failure, so the script exits non-zero and never prints its last line.
Imports torch, numpy, the standard library and the port only.

Output: progress lines, the card's name and power limit as nvidia-smi
prints them, one ``{"kernels": [...]}`` line with each kernel's launches on
the main paths, error against its plain version and times (each also
per shape), and as the last line ``{"ok": true, "device": {...}}``.
K3's ``ms`` is one unchained apply, timed after the warm and clean runs
(as K1's and K2's), not a step of the chain.
"""

from __future__ import annotations

import dataclasses
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

# The implicit-function VJP (f64, B=1024): kernel path vs plain path on the
# card (identical applies, identical iterates), K1 vs K2 form (two solves
# to 1e-10 that differ by rounding), and a central finite difference of the
# loss along one seeded direction (step 1e-4 on solves to 1e-12: truncation
# and solver noise both ~1e-8 of the derivative).
VJP_PATH_RTOL, VJP_FORM_RTOL, VJP_FD_RTOL = 1e-12, 1e-8, 1e-6
FD_STEP, FD_TOL = 1e-4, 1e-12
# Three f64 SVI steps on the card vs on the CPU (plain path), same draws:
# cuDNN and the CPU convolutions sum in another order.
SVI_CPU_RTOL = 1e-8
SVI_STEPS = 200
# K3 chained in its own layout: 8 applies checked bit for bit against the
# plain chain (f32 values stay finite).
K3_CHAIN = 8
K3_CHAIN_PATH = "6 K3 chained apply"
# Every padded shape (R = C, B, dtype) K3 is checked and timed at: the
# highres32 label shape (33^2 nodes, B=1024) in f32 and f64, and the shapes
# the JAX roofline benchmark chains it at (benchmarks/stencil_roofline.py:
# n = 64, 128, 256 with B = 1024, 256, 64 and 128).  No main path launches
# K3; K2 runs beside it at each interior shape.
K3_SHAPES = ((35, 1024, "float32"), (35, 1024, "float64"),
             (67, 1024, "float32"), (131, 256, "float32"),
             (259, 64, "float32"), (259, 128, "float32"))
# The 'highres' MG VJP (f64, B=256): kernel path vs plain path (identical
# applies), vs a Jacobi-preconditioned solve (two PCGs to 1e-10), vs a
# central difference (as above).
HR_VJP_B = 256
MG_JACOBI_RTOL = 1e-8
# The ELBO's terms reported over the 'highres' training run.
HR_TERMS = ("elbo", "ARM_unsupervised_DKL_z", "ARM_unsupervised_logL_x",
            "supervised_logL_x", "supervised_elbo")
# Virtual observables (phase 4c).  The example refreshes every 250 steps
# from step 250; cut to 50 here so that three refreshes fall inside the
# 200 steps.  At the labels the CGR, Gaussian and RBF constraints hold to
# the solve's precision, ||Gamma y - alpha|| / (||Gamma|| ||y||) per sample
# and family; the flux constraints are one-sided and approximate, held to
# the JAX test's bound (tests/test_constraints.py:96-107).  A refresh on
# the card vs the CPU with the same draws, f64.  The energy arm at a small
# temperature from a weak prior approaches the labels (rel-L2, the bound of
# tests/test_constraints.py:420-435).
VO_CADENCE = 50
VO_LABEL_RTOL = {"float64": 1e-10, "float32": F32_FLOOR}
VO_FLUX_BOUND = 0.5
VO_CPU_RTOL = 1e-10
ENERGY_T, ENERGY_PREC, ENERGY_BOUND = 1e-4, 1e-6, 0.2
# Every shape (nodes a side, B, dtype) the main paths launch K1 and K2 at:
# the highres32 label solve (f32), its VJP (f64) and training labels (f64,
# B=256); the VO constraint assembly (f32, B=128) and the energy arm (f64,
# B=128); the five V-cycle levels of the 'highres' MG solve (f32, f64 at
# B=2048), of its VJP and of its training labels (f64, B=256).  Phase 8
# derives each shape's launches from the paths' iteration counts and holds
# this list to them.
MG_NODES = (65, 33, 17, 9, 5)
STENCIL_SHAPES = {
    "apply_stencil": sorted({(33, 1024, "float32"), (33, 1024, "float64"),
                             (33, 256, "float64"), (33, 128, "float32"),
                             (33, 128, "float64")}
                            | {(n, B, d) for n in MG_NODES
                               for B, d in ((2048, "float32"),
                                            (2048, "float64"),
                                            (256, "float64"))},
                            key=lambda s: (-s[0], -s[1], s[2])),
    "apply_stencil_sym": [(33, 1024, "float32"), (33, 1024, "float64")]}
STENCIL_GRIDS = {"apply_stencil": 7, "apply_stencil_sym": 4}


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

    With ``flush`` (a tensor larger than the 50 MB L2, zeroed, or a
    function that reads one) each call is timed
    alone, after the L2 cache was overwritten outside the timed interval,
    so it reads from HBM; a device-side sleep after the flush lets the
    host enqueue the timed call before the device reaches it, so a slow
    host's launch overhead is not in the time.  Without, ``reps`` calls
    run back to back behind such a sleep."""
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
        flush() if callable(flush) else flush.zero_()
        torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def device_profile(fn):
    """Run ``fn`` once under torch.profiler: (device busy ms, wall ms,
    [(kernel name, ms, calls)] largest first).  Busy time is the sum of
    kernel and copy times (kernels of one stream do not overlap); ranges
    that annotate the device timeline (``Optimizer.step#...``) overlap the
    kernels they contain and are left out."""
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
        if ev.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(ev, "is_user_annotation", False):
            ms, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (ms + ev.device_time / 1e3, n + 1)
    rows = sorted(((k, ms, n) for k, (ms, n) in kernels.items()),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), wall, rows


def stencil_cost(name, Ny, Nx, B, item):
    """(bytes, bound ms, bound_by) of one K1/K2 apply: each input read
    once (coefficient grids, v, mask), the output written once, and 14 f32
    flops per output (7 mul, 6 add, 1 mask mul)."""
    moved = (STENCIL_GRIDS[name] + 2) * Ny * Nx * B * item + Ny * Nx * item
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 14 * Ny * Nx * B / F32_FLOPS_PER_S * 1e3
    return moved, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def shape_inputs(name, n, B, dtype, gen):
    """Random K1 (``apply_stencil``) or K2 inputs at (n, n, B) on the
    card: coefficients of log-normal conductivities, normal v, the 'ND'
    free mask; ``gen`` is a CUDA generator."""
    import torch
    from generative_physics_informed_pde_tpu_torch import fem

    grid = fem.StructuredTriGrid(n - 1, n - 1)
    op = fem.StencilOperator(grid)
    dt = getattr(torch, dtype)
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=gen,
                                   device="cuda", dtype=dt))
    c = op.coefficients_sym(alphas) if name == "apply_stencil_sym" \
        else op.coefficients(alphas)
    coefs = c.permute(1, 2, 3, 0).contiguous()
    v = torch.randn(n, n, B, generator=gen, device="cuda", dtype=dt)
    mask = torch.as_tensor(fem.DirichletProfile(grid).free_mask.reshape(
        n, n, 1), dtype=dt, device="cuda")
    return coefs, v, mask


def bits(x):
    """The bit patterns of a float tensor (signed zeros and NaNs
    compare as bits)."""
    import torch

    return x.view(torch.int32 if x.element_size() == 4 else torch.int64)


def stencil_inputs(op, profile, B, dtype, gen, sym=False):
    import torch

    grid = op.grid
    Ny, Nx = grid.ny + 1, grid.nx + 1
    alphas = torch.exp(torch.randn(B, grid.n_cells, generator=gen,
                                   dtype=torch.float64)).to(dtype).cuda()
    c = op.coefficients_sym(alphas) if sym else op.coefficients(alphas)
    coefs = c.permute(1, 2, 3, 0).contiguous()
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
    """Route the batched solver's stencil applies (both forms), the
    V-cycle's and ``fem.assembly``'s (the virtual observables') through
    their plain PyTorch versions for the duration of a ``with`` block."""

    def __enter__(self):
        from generative_physics_informed_pde_tpu_torch.fem import (
            assembly, batched_solver, multigrid)
        from generative_physics_informed_pde_tpu_torch.ops import (
            apply_stencil_reference, apply_stencil_sym_reference)

        self.targets = ((batched_solver, "apply_stencil",
                         apply_stencil_reference),
                        (batched_solver, "apply_stencil_sym",
                         apply_stencil_sym_reference),
                        (multigrid, "apply_stencil", apply_stencil_reference),
                        (assembly, "apply_stencil", apply_stencil_reference))
        self.saved = [getattr(m, n) for m, n, _ in self.targets]
        for m, n, f in self.targets:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.targets, self.saved):
            setattr(m, n, f)


class injected_draws:
    """Replace the port's samplers (posterior draws, reparametrised draws,
    minibatch indices, channel-dropout masks, the virtual observables'
    propagation draws and test functions) with numpy draws from ``seed`` in
    call order, on the device of the tensors they feed, for a ``with``
    block: two blocks with one seed give a CPU and a card run the same
    randomness."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        import numpy as np
        import torch
        from generative_physics_informed_pde_tpu_torch.constraints import \
            virtual_observables
        from generative_physics_informed_pde_tpu_torch.inference import \
            variational
        from generative_physics_informed_pde_tpu_torch.models import (
            codec, components, generative)
        from generative_physics_informed_pde_tpu_torch.training import \
            trainer

        rng = np.random.default_rng(self.seed)

        def normal(like):
            return torch.as_tensor(rng.standard_normal(tuple(like.shape)),
                                   dtype=like.dtype, device=like.device)

        def sample(params, generator=None):
            return params["mean"] + torch.exp(params["logsigma"]) \
                * normal(params["logsigma"])

        def sample_all_components(params, generator, n):
            mean = params["mean"][:, None, :]
            logsigma = params["logsigma"][:, None, :]
            return mean + torch.exp(logsigma) * normal(
                logsigma.expand(-1, n, -1))

        def draws(fn):
            def draw(shape, generator, dtype, device):
                return torch.as_tensor(fn(tuple(shape)), dtype=dtype,
                                       device=device)
            return draw

        def reparametrize(generator, mean, logsigma):
            return mean + torch.exp(logsigma) * normal(logsigma)

        def minibatch_indices(generator, num_data, batch_size,
                              device=None):
            return torch.as_tensor(rng.permutation(num_data)[:batch_size],
                                   device=device)

        def dropout_mask(shape, keep, generator, device):
            n, c = shape[0], shape[1]
            return torch.as_tensor(rng.random((n, c)) < keep,
                                   device=device).reshape(n, c, 1, 1)

        self.targets = ((variational, "sample", sample),
                        (variational, "sample_all_components",
                         sample_all_components),
                        (generative, "reparametrize", reparametrize),
                        (components, "reparametrize", reparametrize),
                        (trainer, "minibatch_indices", minibatch_indices),
                        (codec, "dropout_mask", dropout_mask),
                        (virtual_observables, "sketch_normals",
                         draws(rng.standard_normal)),
                        (virtual_observables, "rbf_uniforms",
                         draws(rng.random)))
        self.saved = [getattr(m, n) for m, n, _ in self.targets]
        for m, n, f in self.targets:
            setattr(m, n, f)
        return self

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.targets, self.saved):
            setattr(m, n, f)


def recipe_params(dtype: str = "float32", vo: bool = False):
    """The highres32 recipe of examples/train_highres32.py, ``vo`` its
    ``--vo`` arm: the labeled pool of 384 partitioned into 128 supervised,
    128 VO and 128 validation fields as the example does, 1024 unlabeled
    fields (the example draws 2048 and uses 1024)."""
    from generative_physics_informed_pde_tpu_torch.constraints import (
        vo_spec_preset)
    from generative_physics_informed_pde_tpu_torch.training import (
        TrainerParameters)

    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs.update(dim_latent=16, ptype="NDP", dtype=dtype)
    p.trainer.update(lr_init=1e-2, N_PE_updates=3, N_PE_interval=8,
                     N_monte_carlo_analysis=64,
                     N_monte_carlo_analysis_final=1024,
                     N_monitor_interval=100, N_PE_updates_final=250,
                     N_vo_update_interval=250, N_vo_holdoff=250,
                     N_monte_carlo_vo=128)
    p.scheduler = {"milestones": [250, 1500], "factor": 0.1 ** 0.5}
    p.data.update(N_u=1024, N_s=128, N_u_max=1024, N_s_max=128,
                  N_vo_max=128, N_vo=128 if vo else 0, N_val=128,
                  armortized_bs=64,
                  vo_spec=vo_spec_preset("constrain") if vo else {})
    return p


def event_ms(fn, runs=3):
    """Median CUDA-event time of ``fn`` over ``runs`` calls."""
    import torch

    out = []
    for _ in range(runs):
        t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t_s.record()
        fn()
        t_e.record()
        torch.cuda.synchronize()
        out.append(t_s.elapsed_time(t_e))
    return sorted(out)[len(out) // 2]


def highres_recipe_params(dtype: str = "float32"):
    """The 'highres' recipe of bench.py (``build_trainer``): 128 labeled +
    128 validation pairs, 1024 unlabeled fields, batch 64, Adam 1e-2 with
    sqrt(0.1) decays at 250/1500, the preset's channel dropout 0.2, no
    monitor points."""
    from generative_physics_informed_pde_tpu_torch.training import (
        TrainerParameters)

    p = TrainerParameters()
    p.identifier = "highres"
    p.margs.update(dtype=dtype)
    p.trainer.update(lr_init=1e-2, N_monitor_interval=10 ** 9)
    p.scheduler = {"milestones": [250, 1500], "factor": 0.1 ** 0.5}
    p.data.update(N_u=1024, N_s=128, N_u_max=1024, N_s_max=128, N_val=128,
                  armortized_bs=64)
    return p


def solve_grads(fom, alphas, vals, w, sym, tol=None, precond="auto"):
    """(loss, d loss / d alphas, d loss / d bc, solver) of
    ``loss = sum(w * solve(alphas, vals))``."""
    from generative_physics_informed_pde_tpu_torch.fem.batched_solver \
        import make_batched_fom_solver

    solve = make_batched_fom_solver(fom.op, fom.profile, sym=sym, tol=tol,
                                    precond=precond)
    a = alphas.clone().requires_grad_()
    b = vals.clone().requires_grad_()
    loss = (w * solve(a, b)).sum()
    loss.backward()
    return loss.detach(), a.grad, b.grad, solve


def k3_read_nodes(R, C):
    """Per grid, the nodes of a padded (R, C) grid that one K3 apply reads:
    c0 at the interior nodes, each direction grid at the interior and its
    shift against that direction, v and the mask at the interior and its
    six neighbours (the halo's two far corners are never read)."""
    import numpy as np

    def shifted(dy, dx):  # the nodes (y + dy, x + dx) of interior (y, x)
        s = np.zeros((R, C), bool)
        s[1 + dy:R - 1 + dy, 1 + dx:C - 1 + dx] = True
        return s

    inner = shifted(0, 0)
    v = inner.copy()
    for d in ((1, 0), (0, 1), (1, 1)):
        v |= shifted(*d) | shifted(-d[0], -d[1])
    return dict(c0=int(inner.sum()),
                **{f"c{n}": int((inner | shifted(-d[0], -d[1])).sum())
                   for n, d in (("N", (1, 0)), ("E", (0, 1)), ("D", (1, 1)))},
                v=int(v.sum()))


def k3_cost(R, C, B, item):
    """(bytes, bound ms, bound_by) of one K3 apply on a padded (R, C, B)
    grid: every element it reads, once (``k3_read_nodes``; the mask as many
    nodes as v), the whole output, halo included, written once, and 14 f32
    flops per interior output as K2 plus one input-mask multiply per v
    read."""
    reads = k3_read_nodes(R, C)
    moved = (sum(reads.values()) * B + R * C * B + reads["v"]) * item
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = (14 * (R - 2) * (C - 2) + reads["v"]) * B / F32_FLOPS_PER_S * 1e3
    return moved, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def blocked_shape_inputs(R, B, dtype, gen):
    """K3's inputs at the padded shape (R, R, B) in the halo-padded layout
    (c_halo, vb, mb), made by ``pad_coefs_blocked``, ``pad_blocked`` and
    ``mask_blocked`` from K2's inputs at the interior (``shape_inputs``),
    and those K2 inputs (coefs4, v, mask); ``gen`` is a CUDA generator."""
    import torch
    from generative_physics_informed_pde_tpu_torch.ops import (
        mask_blocked, pad_blocked, pad_coefs_blocked)

    n = R - 2
    c4, v, mask = shape_inputs("apply_stencil_sym", n, B, dtype, gen)
    c_halo = pad_coefs_blocked(c4.permute(3, 0, 1, 2), n, n)
    vb = pad_blocked(v.permute(2, 0, 1), n, n)
    mb = torch.as_tensor(mask_blocked(mask[..., 0].cpu().numpy()),
                         device="cuda")
    return (c_halo, vb, mb), (c4, v, mask)


def rel_diff(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    import numpy as np

    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler, QuerryPointEnsemble,
        build_virtual_observables_ensemble, vo_spec_preset)
    from generative_physics_informed_pde_tpu_torch.factories import highres32
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories.data import (
        DataFactory)
    from generative_physics_informed_pde_tpu_torch.fem.batched_solver \
        import make_batched_fom_solver
    from generative_physics_informed_pde_tpu_torch.factories import highres
    from generative_physics_informed_pde_tpu_torch.ops import (
        _build, apply_stencil, apply_stencil_reference, apply_stencil_sym,
        apply_stencil_sym_blocked, apply_stencil_sym_blocked_reference,
        apply_stencil_sym_reference)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer)

    kernels_ = (apply_stencil, apply_stencil_sym, apply_stencil_sym_blocked)
    main_launches = {k.__name__: 0 for k in kernels_}
    path_launches = {}

    def start_path():
        """Zero every kernel's count just before a main path runs."""
        torch.cuda.synchronize()
        for k in kernels_:
            k.launches = 0

    def end_path(name):
        """Read the counts just after a main path ran."""
        torch.cuda.synchronize()
        path_launches[name] = {k.__name__: k.launches for k in kernels_}
        for k in kernels_:
            main_launches[k.__name__] += k.launches
        return path_launches[name]

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

    # ---------------------- 2 + 2b. K1 and K2 against their plain versions
    gen = torch.Generator().manual_seed(0)
    g33 = fem.StructuredTriGrid(32, 32)
    g9 = fem.StructuredTriGrid(8, 8)
    errors = {}
    for phase, kernel, plain, sym in (
            ("2", apply_stencil, apply_stencil_reference, False),
            ("2b", apply_stencil_sym, apply_stencil_sym_reference, True)):
        name = kernel.__name__
        say(f"phase {phase}: {name} kernel vs its plain version on the card")
        worst_abs = worst_rel = 0.0
        for grid, B, dtype in ((g33, 1024, torch.float32),
                               (g33, 1024, torch.float64),
                               (g9, 11, torch.float32)):
            coefs, v, mask = stencil_inputs(fem.StencilOperator(grid),
                                            fem.DirichletProfile(grid), B,
                                            dtype, gen, sym=sym)
            got = kernel(coefs, v, mask)
            ref = plain(coefs, v, mask)
            torch.cuda.synchronize()
            abs_err = (got - ref).abs().max().item()
            rel_err = abs_err / ref.abs().max().item()
            tol = KERNEL_RTOL[str(dtype).split(".")[-1]]
            say(f"  {tuple(v.shape)} {dtype}: max abs err {abs_err:.3e}, "
                f"max rel err {rel_err:.3e} (tolerance {tol:g} relative)")
            if not rel_err <= tol:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {tuple(v.shape)} {dtype}")
            worst_abs, worst_rel = max(worst_abs, abs_err), max(worst_rel,
                                                                rel_err)
        errors[name] = (worst_abs, worst_rel)

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

    start_path()  # counts from here cover the main path only
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
    label_serve = end_path("3+4 label + serve")

    # ------------------------------------------------ checks of the output
    say("checks: labels")
    if label_launches != iters + 1:
        raise AssertionError(f"{label_launches} launches for {iters} "
                             "iterations (expected one rhs apply + one "
                             "matvec per iteration)")
    if label_serve["apply_stencil"] == 0:
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

    # ------------------------------ 3b. the symmetric-form label solve (K2)
    say("phase 3b: label the same pool with the symmetric 4-grid solve")
    sym_solve = make_batched_fom_solver(fom.op, fom.profile, sym=True)
    start_path()
    t0 = time.perf_counter()
    Y_sym = sym_solve(alphas, vals)
    torch.cuda.synchronize()
    sym_ms_first = 1e3 * (time.perf_counter() - t0)
    iters_sym = sym_solve.iterations
    sym_counts = end_path("3b sym label solve")
    say(f"  labels {tuple(Y_sym.shape)} in {sym_ms_first:.1f} ms, "
        f"{iters_sym} PCG iterations, launches {sym_counts}")
    if sym_counts["apply_stencil_sym"] != iters_sym + 1 \
            or sym_counts["apply_stencil"] != 0:
        raise AssertionError(f"sym solve launches {sym_counts} for "
                             f"{iters_sym} iterations (expected K2 only, "
                             "one rhs apply + one matvec per iteration)")
    res_sym = true_residual(fom, Y_sym, alphas, vals,
                            apply_stencil_reference)
    say(f"  f32 sym labels: true relative residual max "
        f"{res_sym.max().item():.3e} (f32 floor bound {F32_FLOOR:g})")
    if not bool(torch.isfinite(Y_sym).all()) \
            or not bool((res_sym <= F32_FLOOR).all()):
        raise AssertionError("f32 sym labels above the f32 residual floor")
    sym_vs_k1 = ((Y_sym - Y).norm(dim=1) / Y.norm(dim=1)).max().item()
    say(f"  sym (K2) vs 7-grid (K1) labels: rel-L2 max {sym_vs_k1:.3e} "
        f"(bound {F32_FLOOR:g})")
    if not sym_vs_k1 <= F32_FLOOR:
        raise AssertionError("sym labels far from the 7-grid labels")
    Y64_sym = sym_solve(alphas64, vals64)
    res64_sym = true_residual(fom, Y64_sym, alphas64, vals64,
                              apply_stencil_reference)
    say(f"  f64 sym labels ({sym_solve.iterations} iterations): true "
        f"relative residual max {res64_sym.max().item():.3e} (tolerance "
        f"{TOL_F64:g})")
    if not bool((res64_sym <= TOL_F64).all()):
        raise AssertionError("an f64 sym label's residual exceeds the "
                             "tolerance")

    # ------------------------------------------ 3c. the solve's VJP (K1, K2)
    say("phase 3c: gradients of the batched solve, f64, B=1024")
    wgen = torch.Generator().manual_seed(7)
    w = torch.randn(N, fom.dim_out, generator=wgen,
                    dtype=torch.float64).cuda()
    grads, vjp_iters, vjp_solves = {}, {}, {}
    for sym in (False, True):
        start_path()
        _, ga, gb, solver = solve_grads(fom, alphas64, vals64, w, sym)
        counts = end_path(f"3c VJP sym={sym}")
        used = "apply_stencil_sym" if sym else "apply_stencil"
        expect = solver.iterations + solver.adjoint_iterations + 2
        say(f"  sym={sym}: {solver.iterations} forward + "
            f"{solver.adjoint_iterations} adjoint iterations, launches "
            f"{counts}")
        if counts[used] != expect or sum(counts.values()) != expect:
            raise AssertionError(f"VJP sym={sym}: launches {counts}, "
                                 f"expected {expect} of {used} only")
        with plain_applies():
            _, pa, pb, _ = solve_grads(fom, alphas64, vals64, w, sym)
        err = max(rel_diff(ga, pa), rel_diff(gb, pb))
        say(f"    kernel path vs plain path: max rel diff {err:.3e} "
            f"(tolerance {VJP_PATH_RTOL:g})")
        if not err <= VJP_PATH_RTOL:
            raise AssertionError(f"VJP sym={sym}: kernel-path gradients "
                                 "differ from the plain path")
        grads[sym] = (ga, gb)
        vjp_iters[sym] = solver.adjoint_iterations
        vjp_solves[sym] = (solver.iterations, solver.adjoint_iterations)
    err = max(rel_diff(grads[True][0], grads[False][0]),
              rel_diff(grads[True][1], grads[False][1]))
    say(f"  K2-form vs K1-form gradients: max rel diff {err:.3e} "
        f"(tolerance {VJP_FORM_RTOL:g})")
    if not err <= VJP_FORM_RTOL:
        raise AssertionError("the sym and 7-grid gradients disagree")
    d_a = alphas64 * torch.randn(alphas64.shape, generator=wgen,
                                 dtype=torch.float64).cuda()
    d_b = torch.randn(vals64.shape, generator=wgen,
                      dtype=torch.float64).cuda()
    fd_solve = make_batched_fom_solver(fom.op, fom.profile, tol=FD_TOL)
    with torch.no_grad():
        lp = (w * fd_solve(alphas64 + FD_STEP * d_a,
                           vals64 + FD_STEP * d_b)).sum()
        lm = (w * fd_solve(alphas64 - FD_STEP * d_a,
                           vals64 - FD_STEP * d_b)).sum()
    fd = ((lp - lm) / (2 * FD_STEP)).item()
    for sym in (False, True):
        ga, gb = grads[sym]
        dd = ((ga * d_a).sum() + (gb * d_b).sum()).item()
        err = abs(dd - fd) / abs(fd)
        say(f"  sym={sym}: directional derivative {dd:.12e} vs central "
            f"difference {fd:.12e}: rel {err:.3e} (tolerance "
            f"{VJP_FD_RTOL:g})")
        if not err <= VJP_FD_RTOL:
            raise AssertionError(f"VJP sym={sym} disagrees with finite "
                                 "differences")

    # --------------------------------------------- 4b. train the recipe
    say(f"phase 4b: highres32 SVI training, {SVI_STEPS} steps f32")
    start_path()
    t0 = time.perf_counter()
    dl = DataLoader(X[:384])
    dlu = DataFactory.FromIdentifier("highres32").unlabeled(
        1024, torch.Generator().manual_seed(1), device="cuda")
    trainer = CreateTrainer(recipe_params(), dl, dlu, device="cuda")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.run(SVI_STEPS, verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    bundle_t = trainer.export_surrogate()
    served_t = bundle_t.predict(X[384:448], F_rom[384:448])
    train_counts = end_path("4b train + serve")
    elbos = trainer.elbos()
    res = trainer.results()
    say(f"  set-up (labels via K1, unlabeled draws) {setup_s:.2f} s, "
        f"{SVI_STEPS} steps + monitor + final refinement {train_s:.2f} s; "
        f"launches {train_counts}")
    say(f"  ELBO step 0 {elbos[0].item():.6g}, step {SVI_STEPS - 1} "
        f"{elbos[-1].item():.6g}; results {res}")
    if train_counts["apply_stencil"] == 0:
        raise AssertionError("the training path launched apply_stencil 0 "
                             "times")
    if elbos.shape != (SVI_STEPS,) or not bool(torch.isfinite(elbos).all()):
        raise AssertionError("a logged ELBO is not finite")
    first, last = elbos[:20].mean().item(), elbos[-20:].mean().item()
    say(f"  mean ELBO steps 0-19 {first:.6g}, steps "
        f"{SVI_STEPS - 20}-{SVI_STEPS - 1} {last:.6g}")
    if not last > first:
        raise AssertionError("the ELBO did not improve over 200 steps")
    if not all(np.isfinite(res[k]) for k in ("relerr_y", "r2_y",
                                             "logscore_y")):
        raise AssertionError(f"results() not finite: {res}")
    if served_t.shape != (64, fom.dim_out) \
            or not bool(torch.isfinite(served_t).all()):
        raise AssertionError("the trained surrogate's answers are not "
                             "finite of the expected shape")
    say("  the trained surrogate answered 64 requests: finite, "
        f"{tuple(served_t.shape)}")

    say("  3 f64 SVI steps, card vs CPU (plain path), same draws")
    elbo3 = {}
    state = None
    for run, device in (("card", "cuda"), ("cpu", "cpu")):
        dl3 = DataLoader(dl.X, Y=dl.Y, BCE=dl.BCE, F_ROM_BC=dl.F_ROM_BC)
        dlu3 = DataLoader(dlu.X)
        p64 = recipe_params("float64")
        p64.trainer.update(N_monitor_interval=0, N_PE_updates_final=0)
        tr = CreateTrainer(p64, dl3, dlu3, device=device)
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        with injected_draws(11):
            for _ in range(3):
                tr.step()
        elbo3[run] = tr.elbos().double()
    err = ((elbo3["card"] - elbo3["cpu"]).abs()
           / elbo3["cpu"].abs()).max().item()
    say(f"  ELBOs card {elbo3['card'].tolist()} vs CPU "
        f"{elbo3['cpu'].tolist()}: max rel {err:.3e} (tolerance "
        f"{SVI_CPU_RTOL:g})")
    if not err <= SVI_CPU_RTOL:
        raise AssertionError("f64 SVI steps on the card differ from the "
                             "CPU")

    # ------------------- 4c. virtual observables: the recipe's --vo arm
    say("phase 4c: virtual observables (examples/train_highres32.py --vo)")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("TF32 matmuls are on: the VO einsums run in "
                             "full f32 (the JAX package's HIGHEST)")

    def labeled_pool():
        """A loader over 4b's labeled pool: the labels are solved once."""
        return DataLoader(dl.X, X_DG=dl.X_DG, Y=dl.Y, BCE=dl.BCE,
                          F_ROM_BC=dl.F_ROM_BC)

    p_vo = recipe_params(vo=True)
    # cut from the example's 250: three refreshes (steps 50, 100, 150)
    # fall inside the 200 steps
    p_vo.trainer.update(N_vo_holdoff=VO_CADENCE,
                        N_vo_update_interval=VO_CADENCE)
    dlu_vo = DataLoader(dlu.X)
    dlu_vo.lock_physics_assembly()
    start_path()
    t0 = time.perf_counter()
    tr_vo = CreateTrainer(p_vo, labeled_pool(), dlu_vo, device="cuda")
    setup_vo_s = time.perf_counter() - t0
    refreshes, vo_elbos = [], []
    step_vo, refresh_vo = tr_vo.step, tr_vo.update_virtual_observables

    def logged_vo_step():
        logs = step_vo()
        vo_elbos.append(logs["vo_elbo"])
        return logs

    def counted_refresh(step):
        refreshes.append(step)
        return refresh_vo(step)

    tr_vo.step, tr_vo.update_virtual_observables = (logged_vo_step,
                                                    counted_refresh)
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    tr_vo.run(SVI_STEPS, verbose=False)
    t_e.record()
    vo_train_counts = end_path("4c VO train")
    tr_vo.step, tr_vo.update_virtual_observables = step_vo, refresh_vo
    run_vo_s = t_s.elapsed_time(t_e) / 1e3
    vo_samplers = tr_vo.VO.sampler.samplers
    # per assembly: one K1 launch per test column of CGR, Gaussian and
    # RBF and one effective force each; flux is assembled without K1
    k1_per_assembly = sum(s.m + 1 for s in vo_samplers
                          if not isinstance(s, FluxConstrainSampler))
    elbos_vo = tr_vo.elbos()
    vo_elbos = torch.stack(vo_elbos).double().cpu()
    res_vo = tr_vo.results()
    mean_vars = [v for _, v in tr_vo.writer.scalars.get(
        "Monitor/Mean_VO_variances", [])]
    failures = tr_vo.writer.scalars.get("Monitor/VO_conditioning_failures",
                                        [])
    say(f"  set-up {setup_vo_s:.2f} s (m = {tr_vo.VO.m} constraints: "
        f"{[(type(s).__name__, s.m) for s in vo_samplers]}); "
        f"{SVI_STEPS} steps + final refinement {run_vo_s:.2f} s; refreshes "
        f"at {refreshes}; launches {vo_train_counts} ({k1_per_assembly} K1 "
        "per assembly)")
    first, last = elbos_vo[:20].mean().item(), elbos_vo[-20:].mean().item()
    say(f"  ELBO mean steps 0-19 {first:.6g}, steps {SVI_STEPS - 20}-"
        f"{SVI_STEPS - 1} {last:.6g}; vo_elbo step 0 "
        f"{vo_elbos[0].item():.6g}, last {vo_elbos[-1].item():.6g}; "
        f"Mean_VO_variances {mean_vars}; conditioning failures "
        f"{failures}; results {res_vo}")
    if refreshes != [VO_CADENCE * k for k in (1, 2, 3)]:
        raise AssertionError(f"VO refreshed at {refreshes}")
    if vo_train_counts["apply_stencil"] != k1_per_assembly \
            * (1 + len(refreshes)):
        raise AssertionError(f"the VO path launched K1 "
                             f"{vo_train_counts['apply_stencil']} times")
    if elbos_vo.shape != (SVI_STEPS,) \
            or not bool(torch.isfinite(elbos_vo).all()) \
            or not bool(torch.isfinite(vo_elbos).all()) or not last > first:
        raise AssertionError("the VO run's ELBO or vo_elbo is not finite "
                             "and rising")
    if failures or not mean_vars or not np.isfinite(mean_vars).all():
        raise AssertionError(f"VO conditioning failures {failures}, "
                             f"Mean_VO_variances {mean_vars}")
    if not all(np.isfinite(res_vo[k]) for k in ("relerr_y", "r2_y",
                                                "logscore_y")):
        raise AssertionError(f"VO results() not finite: {res_vo}")

    say("  K1 vs plain path at the VO shapes (apply_coeff, apply_Kff, "
        "effective_force)")
    fom_vo = tr_vo.physics["fom"]
    ds_vo = tr_vo.datasets["vo"]
    vgen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for dt in (torch.float32, torch.float64):
        qpe = QuerryPointEnsemble(
            fom_vo, ds_vo.get("X_DG").to(dt),
            torch.as_tensor(ds_vo.get("BCE").constrained_values("fom"),
                            dtype=dt, device="cuda"))
        V = torch.randn(qpe.N, qpe.dim_out, tr_vo.VO.m, generator=vgen,
                        device="cuda", dtype=dt)
        grids = fom_vo.op.to_nodegrid(torch.randn(
            qpe.N, fom_vo.grid.n_nodes, generator=vgen, device="cuda",
            dtype=dt))
        coefs = fom_vo.op.coefficients(qpe.alpha)

        def vo_applies():
            return (fom_vo.op.apply_coeff(coefs, grids), qpe.apply_Kff(V),
                    fom_vo.effective_force(qpe.alpha, qpe.bc_values))

        before = apply_stencil.launches
        got = vo_applies()
        n_k1 = apply_stencil.launches - before
        with plain_applies():
            ref = vo_applies()
        if apply_stencil.launches != before + n_k1 or n_k1 != 2 + V.shape[2]:
            raise AssertionError(f"VO applies launched K1 {n_k1} times")
        for what, a, b in zip(("apply_coeff", "apply_Kff",
                               "effective_force"), got, ref):
            err = rel_diff(a, b)
            worst = max(worst, (a - b).abs().max().item())
            say(f"    {what} {tuple(a.shape)} {dt}: bit-equal "
                f"{torch.equal(bits(a), bits(b))}, max rel {err:.3e} "
                f"(tolerance {KERNEL_RTOL[str(dt).split('.')[-1]]:g})")
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{what} on K1 differs from the plain "
                                     f"path at {dt}")
    errors["apply_stencil"] = (max(errors["apply_stencil"][0], worst),
                               errors["apply_stencil"][1])

    say("  constraints at the FOM labels of the VO chunk")
    Y_vo64 = torch.as_tensor(dl.Y[ds_vo.indices], device="cuda")
    X_DG_vo = ds_vo.get("X_DG")
    bc_vo = torch.as_tensor(ds_vo.get("BCE").constrained_values("fom"),
                            device="cuda")
    Y_vo32 = fom_vo.solve_batched(torch.exp(X_DG_vo).float(), bc_vo.float())
    spec = recipe_params(vo=True).data["vo_spec"]
    for dname, Y_lab in (("float64", Y_vo64), ("float32", Y_vo32)):
        vo_chk = build_virtual_observables_ensemble(
            spec, ds_vo, tr_vo.physics, dtype=getattr(torch, dname))
        G, a = vo_chk.Gamma, vo_chk.alpha
        r = (G @ Y_lab[..., None])[..., 0] - a
        lo = 0
        for s in vo_chk.sampler.samplers:
            rs, Gs = r[:, lo:lo + s.m], G[:, lo:lo + s.m]
            lo += s.m
            if isinstance(s, FluxConstrainSampler):
                val = (rs.abs().max() / Gs.abs().sum(-1).mean()).item()
                bound = VO_FLUX_BOUND
            else:
                val = (rs.norm(dim=1) / (Gs.norm(dim=(1, 2))
                                         * Y_lab.norm(dim=1))).max().item()
                bound = VO_LABEL_RTOL[dname]
            say(f"    {dname} {type(s).__name__} ({s.m}): {val:.3e} "
                f"(bound {bound:g})")
            if not val <= bound:
                raise AssertionError(f"{type(s).__name__} constraints do "
                                     f"not hold at the {dname} labels")

    say("  one constrain refresh, card vs CPU, f64, same draws (twice: the "
        "second learns the precision)")
    phys_cpu = fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu")

    class VOChunk:
        def __init__(self, device):
            self.device = device

        def get(self, key):
            return (X_DG_vo.to(self.device) if key == "X_DG"
                    else ds_vo.get(key))

    with torch.no_grad():
        Y_mean, Y_std = tr_vo.model.propagate_vo_moments(
            tr_vo._data_vo, tr_vo.vo_generator, p_vo.trainer[
                "N_monte_carlo_vo"])
    moments = {}
    for run, device, phys in (("card", "cuda", tr_vo.physics),
                              ("cpu", "cpu", phys_cpu)):
        with injected_draws(13):
            ens = build_virtual_observables_ensemble(
                spec, VOChunk(device), phys, dtype=torch.float64)
            for it in range(2):
                ens.resample(torch.Generator(device))
                ens.update(Y_mean.double().to(device),
                           (1.0 / Y_std ** 2).double().to(device), it)
        moments[run] = (ens.mean.cpu(), ens.vars.cpu(),
                        ens.vo_variances.cpu())
    err = max(rel_diff(a, b) for a, b in zip(moments["card"],
                                               moments["cpu"]))
    say(f"    mean, vars, vo_variances: max rel {err:.3e} (tolerance "
        f"{VO_CPU_RTOL:g})")
    if not err <= VO_CPU_RTOL:
        raise AssertionError("a VO refresh on the card differs from the CPU")

    say("  3 f64 SVI steps across a VO refresh (holdoff 1, interval 2), "
        "card vs CPU, same draws")
    elbo3, vo3, state = {}, {}, None
    for run, device in (("card", "cuda"), ("cpu", "cpu")):
        p64 = recipe_params("float64", vo=True)
        p64.trainer.update(N_monitor_interval=0, N_PE_updates_final=0,
                           N_vo_holdoff=1, N_vo_update_interval=2)
        dlu3 = DataLoader(dlu.X)
        dlu3.lock_physics_assembly()
        tr = CreateTrainer(p64, labeled_pool(), dlu3, device=device)
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        with injected_draws(14):
            for _ in range(3):
                tr.step()
        elbo3[run], vo3[run] = tr.elbos().double(), tr.VO.mean.cpu()
    err = ((elbo3["card"] - elbo3["cpu"]).abs()
           / elbo3["cpu"].abs()).max().item()
    err_vo = rel_diff(vo3["card"], vo3["cpu"])
    say(f"    ELBOs card {elbo3['card'].tolist()} vs CPU "
        f"{elbo3['cpu'].tolist()}: max rel {err:.3e}; VO mean max rel "
        f"{err_vo:.3e} (tolerance {SVI_CPU_RTOL:g})")
    if not max(err, err_vo) <= SVI_CPU_RTOL:
        raise AssertionError("f64 VO SVI steps on the card differ from the "
                             "CPU")

    say("  energy arm (vo_spec_preset('energy')): one update, f64, "
        f"T = {ENERGY_T:g}, weak prior")
    spec_e = vo_spec_preset("energy", T_iterations=SVI_STEPS)
    vo_e = build_virtual_observables_ensemble(spec_e, ds_vo, tr_vo.physics,
                                              dtype=torch.float64)
    vo_e.force_temperature(ENERGY_T)
    G0 = torch.zeros_like(Y_vo64)
    start_path()
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    vo_e.update(G0, torch.full_like(G0, ENERGY_PREC), 0)
    t_e.record()
    energy_counts = end_path("4c energy update")
    energy_ms = t_s.elapsed_time(t_e)
    n_it, n_rbf = (spec_e["energy_num_iterations_per_update"],
                   spec_e["N_rbf"])
    energy_dist = ((vo_e.mean - Y_vo64).norm() / Y_vo64.norm()).item()
    say(f"    {energy_ms:.2f} ms, launches {energy_counts} ({n_it} "
        f"iterations x ({n_rbf} + 1) + 1 effective force); mean vs labels "
        f"rel-L2 {energy_dist:.4f} (the prior's 1.0; bound "
        f"{ENERGY_BOUND:g})")
    if energy_counts["apply_stencil"] != n_it * (n_rbf + 1) + 1:
        raise AssertionError("the energy update launched K1 "
                             f"{energy_counts['apply_stencil']} times")
    if not (bool(torch.isfinite(vo_e.mean).all())
            and energy_dist < ENERGY_BOUND):
        raise AssertionError("the energy arm's mean is not near the labels")

    # ----------------------------------------------------------- 5. times
    say("phase 5: timings (CUDA events, after warm-up)")
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    timing = {}
    for kernel, plain, sym in (
            (apply_stencil, apply_stencil_reference, False),
            (apply_stencil_sym, apply_stencil_sym_reference, True)):
        coefs, v, mask = stencil_inputs(fem.StencilOperator(g33),
                                        fem.DirichletProfile(g33), 1024,
                                        torch.float32, gen, sym=sym)
        # warm first: the 256 MB flushes slow the calls that follow
        k_ms_warm = cuda_time_ms(lambda: kernel(coefs, v, mask), 200)
        p_ms_warm = cuda_time_ms(lambda: plain(coefs, v, mask), 200)
        k_ms = cuda_time_ms(lambda: kernel(coefs, v, mask), 100, flush)
        p_ms = cuda_time_ms(lambda: plain(coefs, v, mask), 100, flush)
        moved, bound_ms, bound_by = stencil_cost(kernel.__name__, *v.shape,
                                                 v.element_size())
        timing[kernel.__name__] = dict(
            ms=k_ms, ms_l2_warm=k_ms_warm, plain_ms=p_ms,
            plain_ms_l2_warm=p_ms_warm, bound_ms=bound_ms,
            bound_by=bound_by, bytes=moved)
        say(f"  {kernel.__name__} {tuple(v.shape)} f32: {k_ms * 1e3:.2f} us "
            f"(L2 flushed), {k_ms_warm * 1e3:.2f} us (L2 warm); plain "
            f"{p_ms * 1e3:.2f} / {p_ms_warm * 1e3:.2f} us; bound "
            f"{bound_ms * 1e3:.2f} us by {bound_by} ({moved / 1e6:.1f} MB)")
    say(f"  launches per label solve: {iters + 1} (K1) / {iters_sym + 1} "
        f"(K2): 1 rhs + one per PCG iteration; per VJP: "
        f"{vjp_iters[False] + 1} (K1) / {vjp_iters[True] + 1} (K2)")

    label_ms = event_ms(lambda: fom.solve_batched(alphas, vals))
    sym_ms = event_ms(lambda: sym_solve(alphas, vals))
    say(f"  label solve, 1024 fields f32: K1 {label_ms:.2f} ms ({iters} "
        f"iterations), sym K2 {sym_ms:.2f} ms ({iters_sym} iterations), "
        f"median of 3 (first K1 run {label_ms_first:.2f} ms host clock)")
    vjp_ms = {sym: event_ms(lambda: solve_grads(fom, alphas64, vals64, w,
                                                sym))
              for sym in (False, True)}
    say(f"  solve + VJP, 1024 fields f64: K1 {vjp_ms[False]:.2f} ms, "
        f"K2 {vjp_ms[True]:.2f} ms (median of 3)")

    def report_profile(what, fn, plain_wall_ms=None):
        """Device busy share of ``fn`` under the profiler; with
        ``plain_wall_ms`` (the same work timed without the profiler, whose
        own overhead stretches the wall) the share is taken of that."""
        busy, wall, rows = device_profile(fn)
        if not rows:
            say(f"  profiled {what}: the profiler saw no device kernels "
                "(device busy share not measured)")
            return None
        say(f"  profiled {what}: device busy {busy:.2f} ms of "
            f"{wall:.2f} ms wall ({100 * busy / wall:.1f}%), "
            f"{sum(r[2] for r in rows)} device kernels and copies")
        if plain_wall_ms is not None:
            say(f"    of {plain_wall_ms:.2f} ms unprofiled wall: "
                f"{100 * busy / plain_wall_ms:.1f}%")
            wall = plain_wall_ms
        for name, ms, n in rows[:10]:
            say(f"    {ms:8.3f} ms {n:6d}x {name[:90]}")
        return busy / wall

    busy_label = report_profile("label solve (K1)",
                                lambda: fom.solve_batched(alphas, vals))
    busy_sym = report_profile("sym label solve (K2)",
                              lambda: sym_solve(alphas, vals))

    def svi_steps(n):
        for _ in range(n):
            trainer.step()

    svi_steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svi_steps(100)
    torch.cuda.synchronize()
    svi_wall_ms = 1e3 * (time.perf_counter() - t0)
    steps_per_s = 100 / (svi_wall_ms / 1e3)
    say(f"  SVI steps (f32, batch 64 + 128 labeled, PE every 8th): "
        f"{steps_per_s:.2f} steps/s over 100 steps")
    busy_svi = report_profile("100 SVI steps", lambda: svi_steps(100),
                              svi_wall_ms)
    say("  VO (phase 4c's trainer): SVI steps, one refresh and its parts")

    def vo_steps(n):
        for _ in range(n):
            tr_vo.step()

    vo_steps(5)
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    gn0 = tr_vo.gn
    t_s.record()
    vo_steps(100)
    t_e.record()
    torch.cuda.synchronize()
    vo_step_ms = t_s.elapsed_time(t_e) / 100
    n_ref = sum(1 for g in range(gn0, gn0 + 100) if g % VO_CADENCE == 0)
    say(f"    {1e3 / vo_step_ms:.2f} SVI steps/s with VO over 100 steps "
        f"({n_ref} refreshes among them; CUDA events)")
    n_mc = p_vo.trainer["N_monte_carlo_vo"]
    with torch.no_grad():
        prop_ms = event_ms(lambda: tr_vo.model.propagate_vo_moments(
            tr_vo._data_vo, tr_vo.vo_generator, n_mc))
        Y_mean, Y_std = tr_vo.model.propagate_vo_moments(
            tr_vo._data_vo, tr_vo.vo_generator, n_mc)
        before = apply_stencil.launches
        resample_ms = event_ms(lambda: tr_vo.VO.resample(tr_vo.vo_generator))
        k1_per_refresh = (apply_stencil.launches - before) // 3
        cond_ms = event_ms(lambda: tr_vo.VO.update(
            Y_mean, 1.0 / Y_std ** 2, tr_vo.gn))
    refresh_ms = event_ms(lambda: tr_vo.update_virtual_observables(
        tr_vo.gn))
    say(f"    refresh {refresh_ms:.2f} ms: propagation ({tr_vo.VO.N} x "
        f"{n_mc} ROM solves) {prop_ms:.2f} ms, resampling ({k1_per_refresh} "
        f"K1 launches) {resample_ms:.2f} ms, conditioning {cond_ms:.2f} ms "
        "(median of 3)")
    if k1_per_refresh != k1_per_assembly:
        raise AssertionError(f"a resample launched K1 {k1_per_refresh} times")
    busy_vo_svi = report_profile(f"100 VO SVI steps ({n_ref} refreshes)",
                                 lambda: vo_steps(100), 100 * vo_step_ms)


    predict_ms = {}
    for b in bundle.buckets:
        xb = x[:b].contiguous()
        fb = F_dev[:b].contiguous()
        predict_ms[b] = cuda_time_ms(lambda: bundle.predict(xb, fb), 20)
        say(f"  predict bucket {b}: {predict_ms[b]:.3f} ms")
    say(f"  card: {card}")


    # ----------- 6. K3: the halo-padded symmetric apply, chained and timed
    say("phase 6: apply_stencil_sym_blocked kernel vs its plain version and "
        "K2 at every K3 shape, chained, timed")
    name = apply_stencil_sym_blocked.__name__
    kgen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    k3_rows = []
    # a scalar-path batch and a partial chunk first, then the K3 shapes
    for R, B, dname in ((11, 11, "float32"), (35, 140, "float32"),
                        *K3_SHAPES):
        (c_halo, vb, mb), (c4, v, mask) = blocked_shape_inputs(R, B, dname,
                                                                kgen)
        vm = (mask * v).contiguous()
        got = apply_stencil_sym_blocked(c_halo, vb, mb)
        ref = apply_stencil_sym_blocked_reference(c_halo, vb, mb)
        k2 = apply_stencil_sym(c4, vm, mask)
        torch.cuda.synchronize()
        abs_err = (got - ref).abs().max().item()
        halo_zero = not any(bool(bits(e).any())
                            for e in (got[0], got[-1], got[:, 0], got[:, -1]))
        ok = (torch.equal(bits(got), bits(ref))
              and torch.equal(bits(got[1:-1, 1:-1]), bits(k2)) and halo_zero)
        say(f"  {(R, R, B)} {dname}: bit-equal to the plain version and to "
            f"K2 on the masked input, output halo +0: {ok}")
        if not ok:
            raise AssertionError(f"{name} is not bit-equal to its plain "
                                 f"version and K2 at {(R, R, B)} {dname}, or "
                                 "its halo is not zero")
        worst = max(worst, abs_err)
        if (R, B, dname) not in K3_SHAPES:
            continue
        moved, bound, by = k3_cost(R, R, B, vb.element_size())
        _, k2_bound, _ = stencil_cost("apply_stencil_sym", R - 2, R - 2, B,
                                      vb.element_size())
        times = {}
        for who, fn in (("k3", lambda: apply_stencil_sym_blocked(c_halo, vb,
                                                                 mb)),
                        ("k2", lambda: apply_stencil_sym(c4, vm, mask))):
            # warm first: the 256 MB flushes slow the calls that follow
            times[who] = (cuda_time_ms(fn, 200),
                          cuda_time_ms(fn, 100, flush.sum),
                          cuda_time_ms(fn, 100, flush))
        (t_w, t_c, t_f), (k2_w, k2_c, k2_f) = times["k3"], times["k2"]
        # ``launches`` is filled in phase 8, from every path's counts
        row = dict(shape=[R, R, B], dtype=dname, bytes=moved,
                   bound_ms=bound, bound_by=by, ms=t_f, ms_l2_clean=t_c,
                   ms_l2_warm=t_w, share_of_bound=bound / t_c,
                   k2=dict(shape=[R - 2, R - 2, B], bound_ms=k2_bound,
                           ms=k2_f, ms_l2_clean=k2_c, ms_l2_warm=k2_w),
                   clean_vs_k2=t_c / k2_c)
        if (R, B, dname) == K3_SHAPES[0]:
            def plain():
                return apply_stencil_sym_blocked_reference(c_halo, vb, mb)

            row.update(plain_ms_l2_warm=cuda_time_ms(plain, 200),
                       plain_ms=cuda_time_ms(plain, 100, flush))
            timing[name] = dict(
                ms=t_f, ms_l2_clean=t_c, ms_l2_warm=t_w,
                plain_ms=row["plain_ms"],
                plain_ms_l2_warm=row["plain_ms_l2_warm"], bound_ms=bound,
                bound_by=by, bytes=moved)
        k3_rows.append(row)
        say(f"    K3 {t_f * 1e3:.2f} / {t_c * 1e3:.2f} / {t_w * 1e3:.2f} us "
            f"(flushed / clean / warm), bound {bound * 1e3:.2f} us by {by} "
            f"({moved / 1e6:.2f} MB), {100 * bound / t_c:.1f}% of it "
            f"(clean); K2 at {(R - 2, R - 2, B)}: {k2_f * 1e3:.2f} / "
            f"{k2_c * 1e3:.2f} / {k2_w * 1e3:.2f} us, bound "
            f"{k2_bound * 1e3:.2f} us; K3 / K2 clean {t_c / k2_c:.3f}"
            + (f"; plain {row['plain_ms'] * 1e3:.2f} / "
               f"{row['plain_ms_l2_warm'] * 1e3:.2f} us (flushed / warm)"
               if "plain_ms" in row else ""))
        del c_halo, vb, mb, c4, v, mask, vm, got, ref, k2
    errors[name] = (worst, 0.0)
    (c_halo, vb, mb), _ = blocked_shape_inputs(*K3_SHAPES[0], kgen)
    start_path()
    chain = vb
    for _ in range(K3_CHAIN):
        chain = apply_stencil_sym_blocked(c_halo, chain, mb)
    k3_counts = end_path(K3_CHAIN_PATH)
    plain_chain = vb
    for _ in range(K3_CHAIN):
        plain_chain = apply_stencil_sym_blocked_reference(c_halo, plain_chain,
                                                          mb)
    say(f"  chained apply v <- K3(c, v, m), {K3_CHAIN} applies at "
        f"{tuple(vb.shape)} f32: launches {k3_counts}")
    if k3_counts[name] != K3_CHAIN \
            or not torch.equal(bits(chain), bits(plain_chain)) \
            or not bool(torch.isfinite(chain).all()):
        raise AssertionError("the K3 chain launched the kernel "
                             f"{k3_counts[name]} times or differs from the "
                             "plain chain")
    say(f"  nodes read per grid by one apply at {tuple(vb.shape)}: "
        f"{k3_read_nodes(*vb.shape[:2])}")
    del c_halo, vb, mb, chain, plain_chain

    # -------------- 7. 'highres': label the 64^2 pool under the V-cycle
    say("phase 7: label the 'highres' pool (2048 fields of 64^2) with the "
        "multigrid-preconditioned solve")
    t0 = time.perf_counter()
    dl_hr = DataFactory.FromIdentifier("highres").labeled(device="cuda")
    draw_s = time.perf_counter() - t0
    X_hr = dl_hr.X
    if X_hr.shape != (2048, 64, 64) or not np.isfinite(X_hr).all():
        raise AssertionError(f"the highres pool is {X_hr.shape}")
    phys_hr = highres().setup(device="cuda")[0]
    fom_hr = phys_hr["fom"]
    solver_hr = fom_hr._batched_solver
    if solver_hr.mg is None:
        raise AssertionError("'auto' did not pick the V-cycle at 64^2")
    per_cycle = solver_hr.mg.applies_per_cycle
    say(f"  pool drawn in {draw_s:.2f} s (KL, {dl_hr.X.shape[0]} fields; "
        f"eigh on the card); V-cycle {solver_hr.mg.num_levels} levels, "
        f"{per_cycle} K1 applies per cycle, maxiter {solver_hr.maxiter}")
    bce_hr = fem.BoundaryConditionEnsemble.from_factory(
        "ND", X_hr.shape[0], np.random.default_rng(0))
    bce_hr.register_function_space("fom", fom_hr.grid)
    bce_hr.register_function_space("rom", phys_hr["rom"].grid)

    def mg_launches(k, first=1):
        """K1 launches of one MG-PCG: the rhs (or K lambda) apply, one
        matvec per iteration, one V-cycle per iteration and one first."""
        return first + k + (k + 1) * per_cycle

    hr = {}
    for dtype in (torch.float32, torch.float64):
        x_hr = torch.as_tensor(X_hr, dtype=dtype, device="cuda")
        a_hr = torch.exp(fom_hr.pixels.image_to_function(x_hr))
        v_hr = torch.as_tensor(bce_hr.constrained_values("fom"), dtype=dtype,
                               device="cuda")
        start_path()
        t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t_s.record()
        Y_hr = fom_hr.solve_batched(a_hr, v_hr)
        t_e.record()
        counts = end_path(f"7 highres labels {dtype}")
        k = fom_hr.last_iterations
        res = true_residual(fom_hr, Y_hr, a_hr, v_hr,
                            apply_stencil_reference).max().item()
        hr[dtype] = dict(Y=Y_hr, alphas=a_hr, vals=v_hr, iterations=k,
                         launches=counts["apply_stencil"], residual=res,
                         ms_first=t_s.elapsed_time(t_e))
        say(f"  {dtype}: {k} PCG iterations, {counts['apply_stencil']} K1 "
            f"launches ({counts}), true relative residual max {res:.3e}, "
            f"{hr[dtype]['ms_first']:.1f} ms (first call)")
        if counts["apply_stencil"] != mg_launches(k) \
                or sum(counts.values()) != counts["apply_stencil"]:
            raise AssertionError(f"MG solve launches {counts}, expected "
                                 f"{mg_launches(k)} of K1 only")
        if not bool(torch.isfinite(Y_hr).all()) or not 0 < k < 60:
            raise AssertionError(f"MG labels not finite or {k} iterations")
    if not hr[torch.float32]["residual"] <= F32_FLOOR \
            or not hr[torch.float64]["residual"] <= TOL_F64:
        raise AssertionError("a highres label's true residual exceeds its "
                             "bound")
    Y32, Y64 = hr[torch.float32]["Y"], hr[torch.float64]["Y"]
    hr_rel32 = ((Y32.double() - Y64).norm(dim=1) / Y64.norm(dim=1)).max(
        ).item()
    say(f"  f32 vs f64 labels: rel-L2 max {hr_rel32:.3e} (bound "
        f"{F32_FLOOR:g}); residual bounds f32 {F32_FLOOR:g}, f64 "
        f"{TOL_F64:g}")
    if not hr_rel32 <= F32_FLOOR:
        raise AssertionError("f32 highres labels far from the f64 labels")
    # K1 at every V-cycle level of this batch (the fine level and the
    # coarse ones), bit for bit against its plain version
    for dtype in hr:
        mg = dataclasses.replace(solver_hr.mg,
                                 dtype=str(dtype).split(".")[-1])
        shapes = []
        for coefs, _, mask in mg.setup(hr[dtype]["alphas"]):
            v = torch.randn(coefs.shape[1:], generator=gen,
                            dtype=dtype).cuda()
            got = apply_stencil(coefs, v, mask)
            if not torch.equal(got, apply_stencil_reference(coefs, v, mask)):
                raise AssertionError(f"apply_stencil differs from its plain "
                                     f"version at {tuple(v.shape)} {dtype}")
            shapes.append(tuple(v.shape))
        say(f"  K1 bit-equal to its plain version on every V-cycle level "
            f"{dtype}: {shapes}")
    with plain_applies():
        before = apply_stencil.launches
        Y_plain_hr = fom_hr.solve_batched(hr[torch.float32]["alphas"],
                                          hr[torch.float32]["vals"])
        if apply_stencil.launches != before:
            raise AssertionError("the plain-path MG solve launched the kernel")
    k_plain = fom_hr.last_iterations
    path_err = ((Y32 - Y_plain_hr).abs().max() / Y_plain_hr.abs().max()
                ).item()
    say(f"  plain-path MG solve f32: {k_plain} iterations (kernel path "
        f"{hr[torch.float32]['iterations']}); labels max rel diff "
        f"{path_err:.3e} (tolerance {PATH_RTOL:g})")
    if k_plain != hr[torch.float32]["iterations"] or not path_err <= PATH_RTOL:
        raise AssertionError("the MG solve on the kernel path differs from "
                             "the plain path")
    del Y_plain_hr
    jac_hr = make_batched_fom_solver(fom_hr.op, fom_hr.profile,
                                     precond="jacobi")
    a32, v32 = hr[torch.float32]["alphas"], hr[torch.float32]["vals"]
    Y_jac = jac_hr(a32, v32)
    jac_rel = ((Y_jac - Y32).norm(dim=1) / Y32.norm(dim=1)).max().item()
    say(f"  Jacobi-PCG on the same pool (f32): {jac_hr.iterations} "
        f"iterations vs {hr[torch.float32]['iterations']} under the V-cycle;"
        f" labels rel-L2 max {jac_rel:.3e} apart (bound {F32_FLOOR:g})")
    if not jac_rel <= F32_FLOOR:
        raise AssertionError("Jacobi and MG labels disagree")
    for i in (0, 2047):
        a64 = hr[torch.float64]["alphas"][i].cpu().numpy()
        direct = fom_hr.solve_direct(a64,
                                     hr[torch.float64]["vals"][i].cpu().numpy())
        err = np.abs(Y64[i].cpu().numpy() - direct).max() / np.abs(
            direct).max()
        if not err <= DIRECT_RTOL:
            raise AssertionError(f"highres sample {i}: f64 MG label vs dense "
                                 f"direct solve {err:.3e}")
    say(f"  f64 MG labels agree with the dense direct solve on 2 samples "
        f"(tolerance {DIRECT_RTOL:g})")
    hr_ms = {str(d).split(".")[-1]: event_ms(
        lambda d=d: fom_hr.solve_batched(hr[d]["alphas"], hr[d]["vals"]))
        for d in hr}
    jac_ms = event_ms(lambda: jac_hr(a32, v32))
    say(f"  label solve, 2048 fields: MG f32 {hr_ms['float32']:.2f} ms, MG "
        f"f64 {hr_ms['float64']:.2f} ms, Jacobi f32 {jac_ms:.2f} ms (median "
        f"of 3)")
    busy_hr = report_profile(
        "MG label solve f32",
        lambda: fom_hr.solve_batched(a32, v32))

    # ------------------------------- 7b. the MG solve's VJP, f64, B=256
    say(f"phase 7b: gradients of the MG solve, f64, 64^2, B={HR_VJP_B}")
    a64 = hr[torch.float64]["alphas"][:HR_VJP_B]
    v64 = hr[torch.float64]["vals"][:HR_VJP_B]
    w_hr = torch.randn(HR_VJP_B, fom_hr.dim_out, generator=wgen,
                       dtype=torch.float64).cuda()
    start_path()
    _, ga, gb, mg_solver = solve_grads(fom_hr, a64, v64, w_hr, False)
    counts = end_path("7b MG VJP")
    k, kadj = mg_solver.iterations, mg_solver.adjoint_iterations
    mg_vjp_launches = mg_launches(k) + mg_launches(kadj)
    say(f"  {k} forward + {kadj} adjoint iterations, launches {counts} "
        f"(expected {mg_vjp_launches} of K1)")
    if counts["apply_stencil"] != mg_vjp_launches \
            or sum(counts.values()) != mg_vjp_launches:
        raise AssertionError("MG VJP launches differ from the count of its "
                             "applies")
    with plain_applies():
        _, pa, pb, _ = solve_grads(fom_hr, a64, v64, w_hr, False)
    err = max(rel_diff(ga, pa), rel_diff(gb, pb))
    say(f"  kernel path vs plain path: max rel diff {err:.3e} (tolerance "
        f"{VJP_PATH_RTOL:g})")
    if not err <= VJP_PATH_RTOL:
        raise AssertionError("MG VJP: kernel path differs from plain path")
    _, ja, jb, jsolver = solve_grads(fom_hr, a64, v64, w_hr, False,
                                     precond="jacobi")
    err = max(rel_diff(ga, ja), rel_diff(gb, jb))
    say(f"  vs Jacobi-PCG solve + VJP ({jsolver.iterations} + "
        f"{jsolver.adjoint_iterations} iterations): max rel diff {err:.3e} "
        f"(tolerance {MG_JACOBI_RTOL:g})")
    if not err <= MG_JACOBI_RTOL:
        raise AssertionError("MG and Jacobi gradients disagree")
    d_a = a64 * torch.randn(a64.shape, generator=wgen,
                            dtype=torch.float64).cuda()
    d_b = torch.randn(v64.shape, generator=wgen, dtype=torch.float64).cuda()
    fd_mg = make_batched_fom_solver(fom_hr.op, fom_hr.profile, tol=FD_TOL)
    with torch.no_grad():
        lp = (w_hr * fd_mg(a64 + FD_STEP * d_a, v64 + FD_STEP * d_b)).sum()
        lm = (w_hr * fd_mg(a64 - FD_STEP * d_a, v64 - FD_STEP * d_b)).sum()
    fd = ((lp - lm) / (2 * FD_STEP)).item()
    dd = ((ga * d_a).sum() + (gb * d_b).sum()).item()
    err = abs(dd - fd) / abs(fd)
    say(f"  directional derivative {dd:.12e} vs central difference "
        f"{fd:.12e}: rel {err:.3e} (tolerance {VJP_FD_RTOL:g})")
    if not err <= VJP_FD_RTOL:
        raise AssertionError("MG VJP disagrees with finite differences")
    mg_vjp_ms = event_ms(lambda: solve_grads(fom_hr, a64, v64, w_hr, False))
    say(f"  MG solve + VJP, {HR_VJP_B} fields f64: {mg_vjp_ms:.2f} ms "
        f"(median of 3)")

    # ------------------------- 7c. train the 'highres' recipe (bench.py)
    say(f"phase 7c: 'highres' SVI training (bench.py recipe), {SVI_STEPS} "
        "steps f32")
    rf_fft = fem.GaussianRandomField.from_image(64, 64, 0.4, 0.8, 0.04,
                                                method="fft")
    start_path()
    t0 = time.perf_counter()
    dl_t = DataLoader(rf_fft.sample(torch.Generator().manual_seed(0), 256,
                                    dtype=torch.float64, device="cuda"
                                    ).cpu().numpy())
    dlu_t = DataLoader(rf_fft.sample(torch.Generator().manual_seed(1), 1024,
                                     dtype=torch.float64, device="cuda"
                                     ).cpu().numpy())
    dlu_t.lock_physics_assembly()
    trainer_hr = CreateTrainer(highres_recipe_params(), dl_t, dlu_t,
                               device="cuda")
    hr_train_label_iters = trainer_hr.physics["fom"].last_iterations
    setup_hr_s = time.perf_counter() - t0
    step_logs = []
    step_fn = trainer_hr.step

    def logged_step():
        logs = step_fn()
        step_logs.append([logs[k] for k in HR_TERMS])
        return logs

    trainer_hr.step = logged_step  # records the ELBO's terms of each step
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    trainer_hr.run(SVI_STEPS, verbose=False)
    t_e.record()
    hr_train_counts = end_path("7c highres train")
    trainer_hr.step = step_fn
    terms = torch.tensor([[float(v) for v in row] for row in step_logs],
                         dtype=torch.float64)
    run_hr_s = t_s.elapsed_time(t_e) / 1e3
    elbos_hr = trainer_hr.elbos()
    res_hr = trainer_hr.results()
    say(f"  set-up (256 labels via MG-PCG on K1, f64; FFT draws) "
        f"{setup_hr_s:.2f} s; {SVI_STEPS} steps + final refinement "
        f"{run_hr_s:.2f} s; launches {hr_train_counts}")
    first, last = elbos_hr[:20].mean().item(), elbos_hr[-20:].mean().item()
    say(f"  ELBO step 0 {elbos_hr[0].item():.6g}, mean steps 0-19 "
        f"{first:.6g}, steps {SVI_STEPS - 20}-{SVI_STEPS - 1} {last:.6g}; "
        f"results {res_hr}")
    for j, k in enumerate(HR_TERMS):
        a, b = terms[:20, j], terms[-20:, j]
        say(f"    {k:>24s}: step 0 {terms[0, j].item():.6g}; steps 0-19 "
            f"mean {a.mean().item():.6g} median {a.median().item():.6g}; "
            f"steps {SVI_STEPS - 20}-{SVI_STEPS - 1} mean "
            f"{b.mean().item():.6g} median {b.median().item():.6g}")
    if hr_train_counts["apply_stencil"] == 0:
        raise AssertionError("the highres training path launched "
                             "apply_stencil 0 times")
    if elbos_hr.shape != (SVI_STEPS,) \
            or not bool(torch.isfinite(elbos_hr).all()) or not last > first:
        raise AssertionError("the highres ELBO is not finite and rising")
    if not all(np.isfinite(res_hr[k]) for k in ("relerr_y", "r2_y",
                                                "logscore_y")):
        raise AssertionError(f"highres results() not finite: {res_hr}")

    def hr_steps(n):
        for _ in range(n):
            trainer_hr.step()

    hr_steps(5)
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    hr_steps(100)
    t_e.record()
    torch.cuda.synchronize()
    hr_step_ms = t_s.elapsed_time(t_e) / 100
    say(f"  SVI steps (f32, batch 64 + 128 labeled, dropout 0.2, PE every "
        f"8th): {1e3 / hr_step_ms:.2f} steps/s over 100 steps (CUDA events)")
    busy_hr_svi = report_profile("50 'highres' SVI steps",
                                 lambda: hr_steps(50), 50 * hr_step_ms)

    say("  3 f64 'highres' SVI steps, card vs CPU (plain path), same draws "
        "and dropout masks")
    elbo3 = {}
    state = None
    for run, device in (("card", "cuda"), ("cpu", "cpu")):
        dl3 = DataLoader(dl_t.X, Y=dl_t.Y, BCE=dl_t.BCE,
                         F_ROM_BC=dl_t.F_ROM_BC)
        dlu3 = DataLoader(dlu_t.X)
        dlu3.lock_physics_assembly()
        tr = CreateTrainer(highres_recipe_params("float64"), dl3, dlu3,
                           device=device)
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        with injected_draws(12):
            for _ in range(3):
                tr.step()
        elbo3[run] = tr.elbos().double()
    err = ((elbo3["card"] - elbo3["cpu"]).abs()
           / elbo3["cpu"].abs()).max().item()
    say(f"  ELBOs card {elbo3['card'].tolist()} vs CPU "
        f"{elbo3['cpu'].tolist()}: max rel {err:.3e} (tolerance "
        f"{SVI_CPU_RTOL:g})")
    if not err <= SVI_CPU_RTOL:
        raise AssertionError("f64 highres SVI steps on the card differ from "
                             "the CPU")

    # ------------------------------ 8. K1 and K2 at every main-path shape
    say("phase 8: K1 and K2 at every shape of the main paths: launches, "
        "bit-equality, times; K3's launches per shape")
    mg = solver_hr.mg
    if mg.num_levels != len(MG_NODES):
        raise AssertionError(f"the V-cycle has {mg.num_levels} levels")

    def mg_by_level(k):
        """K1 launches per V-cycle level (fine first) of one MG-PCG of k
        iterations: the rhs apply and one matvec per iteration on the fine
        level, then per V-cycle the sweeps and residual of each level."""
        per = [(mg.nu_pre + 1 + mg.nu_post) * (k + 1)] * (mg.num_levels - 1)
        per = per + [mg.nu_coarse * (k + 1)]
        per[0] += 1 + k
        return per

    derived = []  # (path, kernel, nodes, B, dtype, launches)
    derived.append(("3+4 label + serve", "apply_stencil", 33, N, "float32",
                    iters + 1))
    derived.append(("3b sym label solve", "apply_stencil_sym", 33, N,
                    "float32", iters_sym + 1))
    for sym, (kf, ka) in vjp_solves.items():
        derived.append((f"3c VJP sym={sym}", "apply_stencil_sym" if sym
                        else "apply_stencil", 33, N, "float64", kf + ka + 2))
    # the recipe's labeled pool is labeled in the loader's dispatches of
    # 256 fields (the last one padded)
    for k in dl.label_iterations:
        derived.append(("4b train + serve", "apply_stencil", 33, 256,
                        "float64", k + 1))
    # the VO path: one constraint assembly at set-up and one per refresh;
    # the energy arm: per iteration its RBF columns and the iterate, and
    # one effective force
    derived.append(("4c VO train", "apply_stencil", 33, tr_vo.VO.N,
                    "float32", k1_per_assembly * (1 + len(refreshes))))
    derived.append(("4c energy update", "apply_stencil", 33, tr_vo.VO.N,
                    "float64", n_it * (n_rbf + 1) + 1))
    mg_solves = [(f"7 highres labels {d}", X_hr.shape[0],
                  str(d).split(".")[-1], hr[d]["iterations"]) for d in hr]
    mg_solves += [("7b MG VJP", HR_VJP_B, "float64", mg_solver.iterations),
                  ("7b MG VJP", HR_VJP_B, "float64",
                   mg_solver.adjoint_iterations),
                  ("7c highres train", len(dl_t.X), "float64",
                   hr_train_label_iters)]
    for path, B, dname, k in mg_solves:
        for nodes, count in zip(MG_NODES, mg_by_level(k)):
            derived.append((path, "apply_stencil", nodes, B, dname, count))
    # K3: phase 6's chain at its first shape (padded nodes), no other path
    k3 = apply_stencil_sym_blocked.__name__
    derived.append((K3_CHAIN_PATH, k3, *K3_SHAPES[0], K3_CHAIN))
    shape_launches = {}
    for path, counts in path_launches.items():
        for kname in (*STENCIL_SHAPES, k3):
            got = sum(r[5] for r in derived if r[0] == path and r[1] == kname)
            if got != counts[kname]:
                raise AssertionError(f"path {path!r}: {kname} launched "
                                     f"{counts[kname]} times, the iteration "
                                     f"counts give {got}")
    for _, kname, nodes, B, dname, count in derived:
        if kname == k3:
            continue
        key = (kname, nodes, B, dname)
        shape_launches[key] = shape_launches.get(key, 0) + count
    # each K3 row: its launches on the paths other than the chain (whose
    # launches are in ``launches_by_path``); every path's K3 count is the
    # derived one, and every derived K3 shape is one of the rows
    k3_derived = [d for d in derived if d[1] == k3]
    if any(d[2:5] not in K3_SHAPES for d in k3_derived):
        raise AssertionError(f"K3 launched outside K3_SHAPES: {k3_derived}")
    for r in k3_rows:
        r["launches"] = sum(
            d[5] for d in k3_derived if d[0] != K3_CHAIN_PATH
            and d[2:5] == (r["shape"][0], r["shape"][2], r["dtype"]))
    say("  K3 launches per shape outside the chain: "
        f"{[(tuple(r['shape']), r['dtype'], r['launches']) for r in k3_rows]}")
    listed = {(k, *sh) for k, shapes in STENCIL_SHAPES.items()
              for sh in shapes}
    if set(shape_launches) != listed:
        raise AssertionError(f"main-path shapes {sorted(shape_launches)} "
                             f"differ from STENCIL_SHAPES")
    say(f"  launches per shape sum to each path's count: {shape_launches}")
    cgen = torch.Generator(device="cuda").manual_seed(8)
    kern = {"apply_stencil": (apply_stencil, apply_stencil_reference),
            "apply_stencil_sym": (apply_stencil_sym,
                                  apply_stencil_sym_reference)}
    shape_rows = {}
    for kname, shapes in STENCIL_SHAPES.items():
        kernel, plain = kern[kname]
        rows = shape_rows[kname] = []
        for nodes, B, dname in shapes:
            coefs, v, mask = shape_inputs(kname, nodes, B, dname, cgen)
            ref = plain(coefs, v, mask)
            got = kernel(coefs, v, mask)
            if not torch.equal(bits(got), bits(ref)):
                raise AssertionError(f"{kname} is not bit-equal to its plain "
                                     f"version at {(nodes, nodes, B)} "
                                     f"{dname}")
            moved, bound, by = stencil_cost(kname, nodes, nodes, B,
                                            v.element_size())
            # warm first: the 256 MB flushes slow the calls that follow
            t_w = cuda_time_ms(lambda: kernel(coefs, v, mask), 200)
            t_c = cuda_time_ms(lambda: kernel(coefs, v, mask), 100,
                               flush.sum)
            t_f = cuda_time_ms(lambda: kernel(coefs, v, mask), 100, flush)
            launches = shape_launches[(kname, nodes, B, dname)]
            # share and excess from the clean time: the inputs come from
            # HBM, as the bound assumes, and no dirty L2 is written back
            # (a warm apply may be served from the L2, faster than HBM)
            rows.append(dict(
                shape=[nodes, nodes, B], dtype=dname, launches=launches,
                bytes=moved, bound_ms=bound, bound_by=by, ms=t_f,
                ms_l2_clean=t_c, ms_l2_warm=t_w,
                share_of_bound=bound / t_c,
                excess_ms=launches * (t_c - bound)))
            del coefs, v, mask, ref, got
    ranked = sorted((r | {"kernel": k} for k, rs in shape_rows.items()
                     for r in rs), key=lambda r: -r["excess_ms"])
    say("  ranked by launches x (clean time - HBM byte bound), all "
        "bit-equal to the plain versions:")
    for r in ranked:
        say(f"    {r['kernel']:>17s} {tuple(r['shape'])!s:>16s} "
            f"{r['dtype']}: {r['launches']:5d} launches, "
            f"{r['ms'] * 1e3:8.2f} / {r['ms_l2_clean'] * 1e3:8.2f} / "
            f"{r['ms_l2_warm'] * 1e3:8.2f} us (flushed / clean / warm), "
            f"bound {r['bound_ms'] * 1e3:7.2f} us "
            f"({100 * r['share_of_bound']:.1f}% of it, clean), "
            f"excess {r['excess_ms']:.3f} ms")
    say(f"  card: {card}")

    # --------------------------------------------------------- 9. records
    say(f"done in {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    src = "generative_physics_informed_pde_tpu_torch/ops/csrc/"
    tpu = "generative_physics_informed_pde_tpu/ops/stencil.py"
    records = [
        ("apply_stencil", "stencil.cu", f"{tpu}:32", "_make_kernel",
         {"launches_per_label_solve": iters + 1,
          "launches_per_vjp": vjp_iters[False] + 1,
          "label_solve_ms": label_ms, "vjp_ms": vjp_ms[False],
          "label_solve_busy_share": busy_label,
          "highres_mg": {
              "launches_per_label_solve": {
                  str(d).split(".")[-1]: hr[d]["launches"] for d in hr},
              "pcg_iterations": {
                  str(d).split(".")[-1]: hr[d]["iterations"] for d in hr},
              "launches_per_vjp": mg_vjp_launches,
              "label_solve_ms": hr_ms, "jacobi_label_solve_ms": jac_ms,
              "jacobi_iterations": jac_hr.iterations,
              "vjp_ms": mg_vjp_ms, "label_solve_busy_share": busy_hr},
          "vo": {
              "launches_per_refresh": k1_per_assembly,
              "refresh_ms": refresh_ms, "propagation_ms": prop_ms,
              "resample_ms": resample_ms, "conditioning_ms": cond_ms,
              "energy_update_launches": energy_counts["apply_stencil"],
              "energy_update_ms": energy_ms}}),
        ("apply_stencil_sym", "stencil_sym.cu", f"{tpu}:129",
         "_make_sym_kernel",
         {"launches_per_label_solve": iters_sym + 1,
          "launches_per_vjp": vjp_iters[True] + 1,
          "label_solve_ms": sym_ms, "vjp_ms": vjp_ms[True],
          "label_solve_busy_share": busy_sym}),
        ("apply_stencil_sym_blocked", "stencil_sym_blocked.cu", f"{tpu}:287",
         "_make_sym_blocked_kernel",
         {"shapes": k3_rows,
          "ms_l2_clean": timing["apply_stencil_sym_blocked"]["ms_l2_clean"]}),
    ]
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": replaces,
        "tpu": f"ops/stencil.py:{body}",
        "launches": main_launches[name],
        "launches_by_path": {p: c[name] for p, c in path_launches.items()},
        **({"shapes": shape_rows[name]} if name in shape_rows else {}),
        "max_abs_err": errors[name][0],
        "max_rel_err": errors[name][1],
        "ms": timing[name]["ms"],
        "ms_l2_warm": timing[name]["ms_l2_warm"],
        "plain_ms": timing[name]["plain_ms"],
        "plain_ms_l2_warm": timing[name]["plain_ms_l2_warm"],
        "bound_ms": timing[name]["bound_ms"],
        "bound_by": timing[name]["bound_by"],
        "library_ms": None,
        **extra,
    } for name, source, replaces, body, extra in records],
        # paths that run no stencil kernel in their steady state
        "paths": {
            "svi": {"steps_per_s": steps_per_s, "busy_share": busy_svi},
            "svi_highres": {"steps_per_s": 1e3 / hr_step_ms,
                            "busy_share": busy_hr_svi},
            "svi_vo": {"steps_per_s": 1e3 / vo_step_ms,
                       "busy_share": busy_vo_svi,
                       "refreshes_per_100_steps": n_ref},
            "predict_ms": {str(b): t for b, t in predict_ms.items()}}}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
