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
card) with the multigrid-preconditioned solve, whose V-cycle runs in the
fused kernels of ``ops/vcycle.py`` (K1 the PCG's matvec), in f32 and f64; differentiate that solve; and
train the recipe of ``bench.py`` (FFT fields, channel dropout 0.2) for 200
SVI steps.  Then BASELINE config 3 (phase 9,
``examples/baseline_configs.py`` ``config3``): 192 labeled and 256
unlabeled 128^2 Matern-3/2 fields drawn with ``DataLoader.from_sampler``,
labeled by the f64 6-level V-cycle, and 200 SVI steps of the
highres128 recipe with 16 Monte-Carlo ELBO samples, its unlabeled term
and prediction-ensemble decodes in bf16 (the 'auto' gates), checked
against full precision and, in f64 with the gates off, card against CPU.
Then persistence and the BASELINE runner ``examples/torch_baseline_configs.py``
(phase 10): config 3 trained in a checkpointed segment, resumed by a fresh
trainer and held against an unbroken run; its surrogate exported to an
on-disk bundle of ``torch.export`` programs, loaded on the card and held
bit for bit against the in-memory bundle at every bucket; the trainer's
metrics file against its in-memory scalars; and config 2 ('highres' 64^2
with the constrain virtual observables on 64 fields) through the runner,
its labels under the fused V-cycle and its constraint assemblies on K1,
with phase 4c's checks.  Phase 9 holds the bf16 gate to its bound at
random inits, twice each: on the JAX package's gate test's model, the
state the bound was set for, and on config 3's; the trained state's terms
are reported.
Then BASELINE config 5 (phase 11, ``examples/torch_uncertainty_study.py``
through the runner's ``config5``): 4 correlation lengths x 4096 FFT fields
of 64^2 in one batched solve of 16,384 systems under the fused V-cycle,
cold and warm, every system's true residual, 256 of the fields in f64 on
the card and the CPU, the per-case QOI moments against numpy's, and its
ParameterStudy saved to a temporary directory and loaded back.
Then the remaining BASELINE configs through the runner, at their published
widths with their steps cut (phases 12-14): config 4 (an 8^2 ROM against
a 256^2 FOM, 10,240 unlabeled fields, the 7-level V-cycle's f64 labels on
K1, three f64 steps card vs CPU), config 512 (a 512^2 FOM, the 8-level
V-cycle, two checkpointed segments, the second resumed, the final
analysis's memory streamed and in one shot, and three f64 steps card vs
CPU), and the virtual-observable
configs 2e, 2h and 2he (energy at 64^2, constrain and energy at 128^2, their
refreshes and energy updates on K1, each checked card vs CPU in f64); every
validation analysis samples the JAX package's Monte-Carlo plan.
Then the rest of the public API (phase 15): single-system solves
(``fom.solve``, K1 at (33,33,1) and (65,65,1)) and their VJPs against the
batched solve, the direct solve and finite differences;
``solve_batched_vmap`` on the 1024 fields, each system stopped on its own
criterion, against the single solves and timed beside ``solve_batched``;
a source and a Neumann flux through ``solve_full``; the ROM calibration,
card against CPU; ``DenseED`` at its class defaults; the highres32
preset's dataset cache in a temporary directory; and
``Analysis.from_encoder`` + ``eval_all``, card against CPU.
Then sharded training and the VO ablation (phase 16): the highres32
recipe through ``setup(mesh=make_mesh(1))``, bit for bit against
``setup()``; two processes started by this script on the one card (gloo,
``--phase16-child``) running the checkpoint lifecycle of the JAX
package's two-process test in f64, each labeling its own rows on K1, held
to the same lifecycle in one process, then training the batches that do
not divide by the shard count (an amortized unlabeled set and minibatch,
Monte-Carlo rows over the replicas), each held to one process, then the
VO ablation's energy and constrain arms at their published 64^2 widths
(64 VO fields, 64 Monte-Carlo samples) in f64 with each process
refreshing its 32 VO rows (its rows, K1 launches, refresh time and peak
memory printed), held to one process; and the three arms of
``examples/torch_vo_ablation.py`` at their published 64^2 widths and
pools, cut to 40 steps.
Then the options the port took over last (phase 17): the V-cycle's steps
in bf16 held bit for bit against their plain versions on config 5's
levels; config 5's 16,384 64^2 fields solved under the bf16 V-cycle
(``precond_dtype="bfloat16"``) beside the f32 V-cycle, every system's
true residual checked; the JAX package's high-contrast 128^2 bf16 case;
phase 10's resumed config 3 surrogate exported for ``("cuda", "cpu")``
and served from both; highres32 steps under ``run(profile_dir=)``; and
three f64 steps on labels solved with given BC encodings.
Last, K1, K2 and the V-cycle's five step kernels run at every shape the
main paths launched them at, each held bit for bit against its plain
version and timed, with its launches derived from the paths' iteration
counts (and checked against the counted launches), and K3's launches per
shape outside its chain are read from the same counts.  All the kernels
are built from the sources
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

import contextlib
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
# Steps under torch.profiler for a device busy share (phases 5 and 7c;
# the profiler's post-processing costs ~1 s a step on a slow host).
PROFILED_STEPS = 10
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
# BASELINE config 3 (phase 9, examples/baseline_configs.py config3): the
# pools (192 labeled, 256 unlabeled 128^2 Matern-3/2 fields), 200 steps
# with a monitor point at 100 (the recipe's is at 200); the f64 labels'
# true relative residual; three f64 steps card vs CPU on 8 + 8 fields with
# the bf16 gates off; the bf16 unlabeled term against full precision,
# evaluated twice, to the JAX test's bound at a random init
# (tests/test_models.py:393-463) on that test's model and on config 3's
# (deterministic there: the JAX package's own term moves 0.0002-0.213
# across random inits of config 3's preset on the CPU, so config 3's value
# holds at its own seed, not at every init); at the trained state it is
# reported only (the steps are not deterministic on the card).
C3_LABELED, C3_UNLABELED, C3_STEPS, C3_MONITOR = 192, 256, 200, 100
C3_RESIDUAL = 1e-10
C3_BF16_RTOL = 0.2
C3_PARAM_RTOL = 1e-7
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
# Phase 10, persistence and the BASELINE runner
# (examples/torch_baseline_configs.py).  (a) Config 3 through the runner's
# _run on phase 9's pools: one segment of C3_RESUME_K steps with a
# checkpoint, then a fresh trainer that restores it and runs C3_RESUME_K
# more, against an unbroken run of 2 * C3_RESUME_K, with deterministic
# cuDNN; the monitor cut from every 200 steps to every C3_RESUME_MONITOR
# and the final refinement from 100 x 3 PE updates to 1 x 3 a run call, so
# that both run inside the short segments.  Bit-equal expected; the JAX
# test's rtol / atol is the bound if an op stays nondeterministic.  (b)
# The resumed trainer's surrogate exported, loaded on the card and held
# bit for bit against the in-memory bundle at every bucket.  (d) Config 2
# ('highres' 64^2, the constrain VO spec, N_monte_carlo_vo=64) through the
# runner, cut from 3000 to C2_STEPS steps and its VO holdoff from 250 to
# C2_HOLDOFF: refreshes at 25, 50 and 100.
C3_RESUME_K, C3_RESUME_MONITOR = 10, 5
RESUME_RTOL, RESUME_ATOL = 1e-6, 1e-7
C2_STEPS, C2_HOLDOFF, C2_VO, C2_LABEL_BATCH = 150, 25, 64, 256
C2_REFRESHES = [25, 50, 100]
C2_PROFILED_STEPS = 10
# Phase 11, BASELINE config 5 (examples/torch_uncertainty_study.py, through
# the runner's config5 module): C5_CASES correlation lengths x C5_B fields
# of C5_N^2 f32 in one batched solve of C5_SYSTEMS under the 5-level
# V-cycle, cold and warm.  Checks: every system's true relative residual
# (f64, plain apply, in slices of C5_SLICE) <= F32_FLOOR; C5_CHECK fields a
# case solved in f64 on the card and on the CPU (plain path), their QOI
# values to C5_F64_RTOL of each other and the f32 sweep's to F32_FLOOR of
# them; the moments against numpy's f64 mean, std (ddof 0) and percentiles
# of the gathered QOI to C5_MOMENT_RTOL.
C5_CASES, C5_B, C5_N = 4, 4096, 64
C5_SYSTEMS = C5_CASES * C5_B
C5_SLICE, C5_CHECK = 4096, 64
C5_F64_RTOL, C5_MOMENT_RTOL = 1e-10, 1e-6
# Phase 12, BASELINE config 4 (examples/torch_baseline_configs.py config4:
# an 8^2 ROM against a 256^2 FOM, FFT fields at l = 0.08, 64 + 32 labeled
# and 10,240 unlabeled fields, batch 32) through the runner, cut from 2000
# to C4_STEPS steps, its monitor from every 500 to every C4_MONITOR steps
# and its final refinement from 100 x 3 to C4_PE_FINAL x 3 PE updates.
# The labels run the 7-level V-cycle in the loader's dispatches of 32
# (2^22 / 131,072 cells).  The analyses' Monte-Carlo plans (chunk,
# n_chunks) are the JAX package's for these pools: a validation label
# holds 4^8 - 1 free dofs, so 32 of them make 2^21 - 32 elements a sample
# and the 2^27 budget splits S = 128 into 2 x 64
# (tests/test_torch_analysis_chunked.py).  Three f64 steps card vs CPU on
# C4_CPU_FIELDS + C4_CPU_FIELDS fields at the full widths, bf16 gates off.
C4_POOLS, C4_STEPS, C4_MONITOR, C4_PE_FINAL = (96, 10240, 0), 40, 20, 10
C4_LABEL_BATCH, C4_CPU_FIELDS = 32, 4
C4_MC_PLANS = {64: (64, 1), 128: (64, 2)}
MG256_NODES = (257, 129, 65, 33, 17, 9, 5)
# Phase 13, config 512 (config 4's recipe at 512^2: 1024 unlabeled fields,
# batch 16) through the runner's _run in two segments of C512_SEG steps
# (cut from 500), checkpointed into a temporary directory; the second
# call resumes there.  The monitor every C512_MONITOR steps of a run call
# (from 500: one monitor point a segment), the final refinement 1 x 3 PE
# updates a run call.  Labels: the 8-level
# V-cycle in dispatches of 8.  Plans: 32 x (4^9 - 1) elements a sample,
# so chunks of 16 (S = 64 in 4, S = 128 in 8).  Three f64 steps card vs
# CPU as config 4's, on C512_CPU_FIELDS + C512_CPU_FIELDS labeled and
# C512_CPU_FIELDS unlabeled fields (batch C512_CPU_FIELDS): the fewest
# that keep more than one sample in every batch statistic, since every
# 512^2 field costs the host's CPU seconds a step.
C512_POOLS, C512_SEG, C512_MONITOR = (96, 1024, 0), 10, 5
C512_LABEL_BATCH, C512_CPU_FIELDS = 8, 2
C512_MC_PLANS = {64: (16, 4), 128: (16, 8)}
MG512_NODES = (513, 257, 129, 65, 33, 17, 9, 5)
# Phase 14, the VO configs through the runner on 64 VO fields: 2e
# ('highres' 64^2, energy VO, updates every 10), 2h (highres128, the
# constrain VO, refreshes every 50), 2he (highres128, energy VO, every
# 10).  Cut: the holdoff (50 / 250 / 50) to VO_HOLDOFF and the steps
# (1000 / 1000 / 2000) to VO_STEPS[c], so that the refreshes or updates of
# VO_REFRESHES[c] fall inside; the final refinement 100 x 3 to
# VO_PE_FINAL x 3 PE updates; the energy arm's temperature schedule still
# spans the recipe's T_iterations.  The final analysis over 64 fields of
# 4^7 - 1 (or 4^6 - 1) dofs runs in one chunk of 128, as the JAX package's.
VO_CONFIGS = ("2e", "2h", "2he")
VO_POOLS, VO_HOLDOFF, VO_PE_FINAL = (192, 1024, 0), 10, 10
VO_STEPS = {"2e": 40, "2h": 60, "2he": 40}
VO_REFRESHES = {"2e": [10, 20, 30], "2h": [10, 50], "2he": [10, 20, 30]}
VO_MC_PLAN = (128, 1)
# Every VO config's conditioning failures are read over its run and its
# timing block and reported, not refused: in f32 a Cholesky of a Schur
# matrix whose equilibrated condition number nears 1e7 completes or fails
# by rounding alone, in both packages, and a failed sample falls back to
# its prior moments as in the JAX package
# (tests/test_torch_vo_conditioning_breakdown.py).  The stored moments
# must stay finite.  Config 2h's failing update's inputs are dumped
# (GPIPDE_VO_DUMP) to VO_DUMP.
VO_DUMP_CONFIG = "2h"
VO_DUMP = ROOT / "build" / "vo_dump_2h.npz"
# Phase 15, the rest of the API on the card.  (a) P15_SINGLE f64 single
# solves of the labeled highres32 fields (K1 at (33,33,1)) and their VJPs,
# held to the batched solve and its VJP to P15_BATCHED_RTOL (both PCGs stop
# at a 1e-10 relative residual, the batched one only when its slowest
# system has: on the CPU the two differ by up to 9.9e-10 over the 1024
# fields), to the dense direct solve to DIRECT_RTOL (phase 3's bound; 7.3e-10
# on the CPU over these 8 fields), and to a central
# difference on 2 cells (FD_STEP, a solver to FD_TOL) to VJP_FD_RTOL; two
# 'highres' 64^2 FFT fields (K1 at (65,65,1)) and a forced solve to the
# dense solve; one f32 solve to the residual floor.  (b)
# solve_batched_vmap's rows hold their single solves to P15_SINGLE_RTOL
# (the same iterates, kept per system by a select).  (d) The calibration
# at the JAX package's defaults (300 Adam steps, lr 1e-2), card vs CPU
# f64, and the Galerkin oracle to the JAX test's 0.5.  (e) DenseED at its
# class defaults, blocks (3, 6, 3), on 64 fields of 64^2 f32; card vs CPU
# f64 on 4.  (f) The highres32 preset's dataset cache; a subclass with
# P15_STALE_N labeled fields is stale.  (g) The analysis over 64 fields
# with 64 Monte-Carlo samples, card vs CPU f64 under injected draws.
P15_SINGLE, P15_BATCHED_RTOL = 8, 1e-8
P15_SINGLE_RTOL, P15_CAL_RTOL, P15_ROM_BOUND = 1e-12, 1e-8, 0.5
P15_ED_BLOCKS, P15_ED_FIELDS, P15_ED_RTOL = (3, 6, 3), 64, 1e-10
P15_STALE_N = 512
P15_ANALYSIS_FIELDS, P15_ANALYSIS_MC, P15_ANALYSIS_RTOL = 64, 64, 1e-8
# Phase 16, sharded training and the VO ablation.  (a) The highres32 recipe
# (phase 4b's pools, f32) P16_STEPS steps through setup(mesh=make_mesh(1))
# against setup(), deterministic cuDNN: bit-equal.  (b) tests/_dcn_child.py's
# lifecycle in f64 (24 + 16 fields of 32^2 at correlation length 0.15, seed
# 11) by two processes on the one card (gloo: one card, two processes; a
# hybrid ("dcn", "dp") mesh of (1, 2)), each labeling its own supervised rows
# on K1: P16_LIFE_STEPS steps with a monitor point, save, restore, 2 more,
# finalize; held to the same lifecycle in one process on the card to
# P16_RTOL, the children killed after P16_CHILD_TIMEOUT s.  (c)
# examples/torch_vo_ablation.py's three arms through main / run_arm at the
# published 64^2 widths and pools (N_s 64, N_u 1024, N_vo 64, N_val 64,
# batch 64), cut from 4000 to P16_ABL_STEPS iterations (the milestones and
# the energy arm's T_iterations scale with them in _params: [10, 25], 41),
# the constrain arm's cadence from 250 to P16_ABL_HOLDOFF (--cadence) and
# the energy arm's holdoff from 50 to P16_ABL_HOLDOFF, so that refreshes and
# energy updates fall at P16_REFRESHES.
P16_STEPS, P16_LIFE_STEPS, P16_RTOL, P16_CHILD_TIMEOUT = 10, 6, 1e-9, 300
P16_ABL_STEPS, P16_ABL_HOLDOFF, P16_REFRESHES = 40, 10, [10, 20, 30]
# (d) Batches that do not divide by the shard count, in the same two
# processes after the lifecycle (tests/test_torch_uneven_sharding.py's
# runs): the lifecycle's pools, labeled once on K1 by this process, f64,
# P16_UNEVEN_STEPS steps each (the last P16_UNEVEN_STEPS - 1 timed), held
# to one process on the card to P16_RTOL.  Name -> (mesh: "dp" a dp=2 mesh,
# "mc" a ("dp", "mc") mesh of (1, 2); the recipe's seed and changes).
P16_UNEVEN_STEPS = 4
P16_UNEVEN = {
    # 15 unlabeled fields: the set stays whole on both processes
    "N_u_amortized": ("dp", dict(seed=11, data=dict(N_u=15))),
    # a minibatch of 1: the second process holds none of it
    "empty_share": ("dp", dict(seed=11, data=dict(armortized_bs=1))),
    # a minibatch of 7 lies 4 / 3, with dropout, fused decodes, normalize
    "armortized_bs": ("dp", dict(seed=11, data=dict(armortized_bs=7),
                                 margs=dict(droprate=0.2, fuse_decodes=True),
                                 trainer=dict(normalize=True))),
    # 5 labeled fields x 3 samples: 15 Monte-Carlo rows lie 8 / 7
    "mc_rows": ("mc", dict(seed=13, n_mc=3, data=dict(N_s=5),
                           margs=dict(droprate=0.2))),
}
# (e) The virtual observables split over the same two processes, after
# (d): examples/torch_vo_ablation.py's energy and constrain arms (its
# _params: the 'highres' 64^2 recipe, N_vo 64 and N_monte_carlo_vo 64; the
# energy arm 10 subspace iterations of 32 RBF columns an update, 331 K1
# launches; the constrain arm's CGR, flux, 8 Gaussian and 8 RBF test
# functions) in f64, its pools cut from N_s 64, N_val 64 and N_u 1024
# (batch 64) to P16_VO_POOLS, the VO refreshed every 2 steps from step 0
# (the holdoffs and cadences cut from 50 / 10 and 250), P16_VO_STEPS steps,
# on fields labeled once here on K1; each process refreshes its 32 of the
# 64 VO rows (the energy arm's applies at (65,65,32) f64, the constrain
# arm's assembly whole at (65,65,64) f64), held to one process on the card
# to P16_RTOL.
P16_VO_STEPS, P16_VO_N = 3, 64
P16_VO_POOLS = dict(N_s=8, N_val=8, N_u=16, armortized_bs=8)
P16_VO_ARMS = ("energy", "constrain")
MG_NODES = (65, 33, 17, 9, 5)
# Phase 17: the JAX package's high-contrast bf16 V-cycle case
# (tests/test_multigrid.py: 128^2, B = 4, lognormal sigma 1.3, left/right
# values 0/1), whose true residual must stay under 10 x its PCG tol; the
# two-platform bundle's CPU program against the card's module (TF32 off:
# the convolutions differ in summation order only); the profiled highres32
# run; and three f64 steps on labels solved with given BC encodings (one
# dispatch of 256 fields).
P17_HC_N, P17_HC_B, P17_HC_SIGMA, P17_HC_TOL = 128, 4, 1.3, 2e-6
P17_CPU_RTOL = 1e-5
P17_PROFILED_STEPS = 10
P17_BCE_LABELED, P17_BCE_UNLABELED, P17_BCE_STEPS = 256, 64, 3
# BASELINE config 3 (phase 9): the six V-cycle levels of the 128^2 f64
# label solve, in the loader's dispatches of 128 fields.
MG128_NODES = (129, 65, 33, 17, 9, 5)
C3_LABEL_BATCH = 128
# The port's kernel wrappers whose launches the paths count: K1, K2, K3
# and the V-cycle's steps (``ops/vcycle.py``; no TPU counterpart).
STENCILS = ("apply_stencil", "apply_stencil_sym",
            "apply_stencil_sym_blocked")
FUSED = ("vcycle_presmooth", "vcycle_restrict", "vcycle_correct",
         "vcycle_smooth", "vcycle_coarse")
# Every V-cycle the main paths run, (levels, B, dtype): the 'highres' MG
# solve (f32, f64 at B=2048), its VJP and training labels (f64, B=256);
# BASELINE config 3's labels (128^2, f64, B=128); config 2's labels
# ('highres' levels, f64, B=256); config 5's sweep (f32, B=16,384) and
# phase 17's bf16 V-cycle on its pool; config 4's labels (256^2, f64,
# B=32) and config 512's (512^2, f64, B=8); the VO configs' labels (2e:
# 'highres' levels, B=256; 2h, 2he: config 3's levels, B=128; f64) and
# phase 16's labels (the 'highres' levels, f64, B=256).  Each step runs on
# every level above the coarsest, ``vcycle_coarse`` on the coarsest.
VCYCLE_RUNS = sorted({(MG_NODES, B, d) for B, d in (
    (2048, "float32"), (2048, "float64"), (256, "float64"),
    (C2_LABEL_BATCH, "float64"), (C5_SYSTEMS, "float32"),
    (C5_SYSTEMS, "bfloat16"))}
    | {(MG128_NODES, C3_LABEL_BATCH, "float64"),
       (MG256_NODES, C4_LABEL_BATCH, "float64"),
       (MG512_NODES, C512_LABEL_BATCH, "float64")})
VCYCLE_SHAPES = {name: sorted(
    {(n, B, d) for levels, B, d in VCYCLE_RUNS
     for n in (levels[-1:] if name == "vcycle_coarse" else levels[:-1])},
    key=lambda s: (-s[0], -s[1], s[2])) for name in FUSED}
# Every shape (nodes a side, B, dtype) the main paths launch K1 and K2 at:
# the highres32 label solve (f32), its VJP (f64) and training labels (f64,
# B=256); the VO constraint assembly (f32, B=128) and the energy arm (f64,
# B=128); the rhs and the matvecs of every MG-PCG on the fine level of its
# V-cycle run (in the solve's dtype: f32 under the bf16 V-cycle); config
# 2's VO applies (65^2 nodes, f32, B=64); the VO configs' VO applies (2e
# at (65,65,64) f32, 2h and 2he at (129,129,64) f32); phase 15's
# single-system solves ((33,33,1) f64 and f32, (65,65,1) f64) and its vmap
# solves ((33,33,1024) f64 and f32); phase 17's BCE-encoded labels
# ((33,33,256) f64); phase 16e's VO applies ((65,65,64) f64 in one
# process, (65,65,32) f64 in each of two).  Phase 8 derives each shape's
# launches (and the V-cycle steps') from the paths' iteration counts and
# holds these lists to them.
STENCIL_SHAPES = {
    "apply_stencil": sorted({(33, 1024, "float32"), (33, 1024, "float64"),
                             (33, 256, "float64"), (33, 128, "float32"),
                             (33, 128, "float64")}
                            | {(levels[0], B,
                                "float32" if d == "bfloat16" else d)
                               for levels, B, d in VCYCLE_RUNS}
                            | {(MG_NODES[0], C2_VO, "float32")}
                            | {(MG128_NODES[0], C2_VO, "float32")}
                            | {(33, 1, "float64"), (33, 1, "float32"),
                               (65, 1, "float64")}
                            | {(MG_NODES[0], P16_VO_N, "float64"),
                               (MG_NODES[0], P16_VO_N // 2, "float64")},
                            key=lambda s: (-s[0], -s[1], s[2])),
    "apply_stencil_sym": [(33, 1024, "float32"), (33, 1024, "float64")]}
STENCIL_GRIDS = {"apply_stencil": 7, "apply_stencil_sym": 4}


_T0 = time.perf_counter()
# (phase name, seconds since the import at its first line)
PHASE_STARTS = []


def say(msg: str) -> None:
    """A progress line, prefixed with the seconds since the import."""
    t = time.perf_counter() - _T0
    if msg.startswith("phase "):
        PHASE_STARTS.append((msg.split(":")[0], t))
    print(f"[chip_smoke {t:6.1f}s] {msg}", flush=True)


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
    free mask; ``gen`` is a CUDA generator.  bf16 inputs are drawn in f32
    and rounded."""
    import torch
    from generative_physics_informed_pde_tpu_torch import fem

    if dtype == "bfloat16":
        return tuple(t.to(torch.bfloat16).contiguous() for t in
                     shape_inputs(name, n, B, "float32", gen))
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

    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


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
    single-system solver's, the V-cycle's steps and ``fem.assembly``'s (the
    virtual observables') through
    their plain PyTorch versions for the duration of a ``with`` block;
    ``launched`` then holds the kernel launches made inside it, by name
    (none on a plain path)."""

    def __enter__(self):
        from generative_physics_informed_pde_tpu_torch.fem import (
            assembly, batched_solver, multigrid, solvers)
        from generative_physics_informed_pde_tpu_torch.ops import (
            apply_stencil_reference, apply_stencil_sym_reference, vcycle)

        self.targets = ((batched_solver, "apply_stencil",
                         apply_stencil_reference),
                        (solvers, "apply_stencil", apply_stencil_reference),
                        (batched_solver, "apply_stencil_sym",
                         apply_stencil_sym_reference),
                        *((multigrid, f"vcycle_{step}",
                           getattr(vcycle, f"vcycle_{step}_reference"))
                          for step in ("presmooth", "restrict", "correct",
                                       "smooth", "coarse")),
                        (assembly, "apply_stencil", apply_stencil_reference))
        self.saved = [getattr(m, n) for m, n, _ in self.targets]
        for m, n, f in self.targets:
            setattr(m, n, f)
        self.before = launch_counts()
        return self

    def __exit__(self, *exc):
        for (m, n, _), f in zip(self.targets, self.saved):
            setattr(m, n, f)
        self.launched = {k: n - self.before[k]
                         for k, n in launch_counts().items()
                         if n != self.before[k]}


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

        rng = self.rng = np.random.default_rng(self.seed)

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

        def standard_normal(shape, like, generator=None):
            return torch.as_tensor(rng.standard_normal(tuple(shape)),
                                   dtype=like.dtype, device=like.device)

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
                        (components, "standard_normal", standard_normal),
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


def mg_rows(path, mg, nodes, B, dname, k):
    """Derived launches [(path, kernel, nodes, B, dtype, launches)] of one
    MG-PCG of k iterations in ``dname`` on the V-cycle ``mg`` over the
    levels ``nodes`` (fine first): K1 for the rhs (or the adjoint's
    K lambda) and one matvec an iteration on the fine level; each of the
    k + 1 V-cycles one launch of every step a level above the coarsest
    (``vcycle_smooth`` once a sweep past the fused ones) and one of
    ``vcycle_coarse`` on the coarsest, in the V-cycle's dtype (float64
    for an f64 solve)."""
    if len(nodes) != mg.num_levels:
        raise AssertionError(f"{path}: a V-cycle of {mg.num_levels} levels "
                             f"on {nodes}")
    vdt, cycles = "float64" if dname == "float64" else mg.dtype, k + 1
    smooths = max(mg.nu_pre - 2, 0) + max(mg.nu_post - 1, 0)
    rows = [(path, "apply_stencil", nodes[0], B, dname, 1 + k)]
    for n in nodes[:-1]:
        rows += [(path, name, n, B, vdt, cycles * per) for name, per in (
            ("vcycle_presmooth", 1), ("vcycle_restrict", 1),
            ("vcycle_correct", 1), ("vcycle_smooth", smooths)) if per]
    rows.append((path, "vcycle_coarse", nodes[-1], B, vdt, cycles))
    if sum(r[5] for r in rows[1:]) != cycles * mg.launches_per_cycle:
        raise AssertionError(f"{path}: the steps' launches differ from "
                             f"{cycles} x launches_per_cycle")
    return rows


def launch_counts():
    """Every kernel wrapper's launch counter, by name."""
    from generative_physics_informed_pde_tpu_torch import ops

    return {name: getattr(ops, name).launches for name in STENCILS + FUSED}


def check_launches(what, counts, rows):
    """A path's counted launches ``counts`` (every kernel by name) against
    the derived ``rows``: equal for every kernel."""
    want = dict.fromkeys(counts, 0)
    for r in rows:
        want[r[1]] += r[5]
    if want != counts:
        raise AssertionError(f"{what} launched {counts}, the iteration "
                             f"counts give {want}")


def vcycle_cost(name, n, B, item, nu_coarse):
    """(bytes, bound ms, bound_by) of one V-cycle step at level (n, n, B)
    in a type of ``item`` bytes: the 7 coefficient grids and r read once,
    z too but in presmooth and coarse, the output written once, the
    free-node masks read once; restrict writes a coarse field and correct
    reads one.  18 f32 flops a node a sweep (K1's 14, the residual's
    difference and the update's two products and sum): presmooth two
    sweeps, coarse ``nu_coarse``, the others one."""
    step = name.split("_", 1)[1]
    nc = (n + 1) // 2
    fields = {"presmooth": 9, "restrict": 9, "correct": 10, "smooth": 10,
              "coarse": 9}[step]
    moved = fields * n * n * B * item + n * n * item
    if step in ("restrict", "correct"):
        moved += nc * nc * B * item
    if step == "restrict":
        moved += nc * nc * item
    sweeps = {"presmooth": 2, "coarse": nu_coarse}.get(step, 1)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 18 * sweeps * n * n * B / F32_FLOPS_PER_S * 1e3
    return moved, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def vcycle_args(name, mg, coefs, mask, r, z, coarse_mask, ec):
    """The arguments of V-cycle step ``name`` as ``mg.apply`` passes them
    on a level (``coarse_mask`` and ``ec`` of the coarser level)."""
    return {"vcycle_presmooth": (coefs, mask, r, mg.omega,
                                 min(mg.nu_pre, 2)),
            "vcycle_restrict": (coefs, mask, r, z, coarse_mask),
            "vcycle_correct": (coefs, mask, r, z, ec, mg.omega,
                               min(mg.nu_post, 1)),
            "vcycle_smooth": (coefs, mask, r, z, mg.omega),
            "vcycle_coarse": (coefs, mask, r, mg.omega, mg.nu_coarse)}[name]


def vcycle_inputs(n, B, dtype, gen):
    """Random inputs of the V-cycle's steps at level (n, n, B) on the card:
    K1's (coefs, mask) and r of ``shape_inputs``, a normal z, and the
    coarser level's 'ND' free mask and a normal e at ((n+1)/2, (n+1)/2,
    B); ``gen`` is a CUDA generator, bf16 drawn in f32 and rounded."""
    import torch
    from generative_physics_informed_pde_tpu_torch import fem

    coefs, r, mask = shape_inputs("apply_stencil", n, B, dtype, gen)
    nc = (n + 1) // 2

    def normal(m):
        return torch.randn(m, m, B, generator=gen, device="cuda",
                           dtype=torch.float64 if dtype == "float64"
                           else torch.float32).to(r.dtype)

    coarse_mask = torch.as_tensor(fem.DirichletProfile(
        fem.StructuredTriGrid(nc - 1, nc - 1)).free_mask.reshape(nc, nc, 1),
        dtype=r.dtype, device="cuda")
    return coefs, mask, r, normal(n), coarse_mask, normal(nc)


def vcycle_levels_check(mg, alphas, gen):
    """Every V-cycle step bit for bit against its plain version on every
    level of ``mg.setup(alphas)`` (in ``mg.dtype``), with normal r and z
    and the coarser level's mask and a normal e; ``gen`` a CPU generator.
    Returns the levels' shapes."""
    import torch
    from generative_physics_informed_pde_tpu_torch.ops import vcycle

    levels = mg.setup(alphas)
    shapes = []
    for li, (coefs, mask) in enumerate(levels):
        def normal(shape):
            return torch.randn(shape, generator=gen, dtype=torch.float64
                               ).to(coefs.dtype).cuda()

        r, z = normal(coefs.shape[1:]), normal(coefs.shape[1:])
        last = li == len(levels) - 1
        coarse_mask, ec = (None, None) if last else (
            levels[li + 1][1], normal(levels[li + 1][0].shape[1:]))
        for name in (FUSED[-1:] if last else FUSED[:-1]):
            args = vcycle_args(name, mg, coefs, mask, r, z, coarse_mask, ec)
            got = getattr(vcycle, name)(*args)
            ref = getattr(vcycle, f"{name}_reference")(*args)
            if got.dtype != ref.dtype or got.shape != ref.shape \
                    or not torch.equal(bits(got), bits(ref)):
                raise AssertionError(f"{name} is not bit-equal to its plain "
                                     f"version at {tuple(r.shape)} "
                                     f"{mg.dtype}")
        shapes.append(tuple(r.shape))
    return shapes


def config3_params(dtype: str = "float32", n_labeled: int = 128,
                   n_unlabeled: int = 256, n_val: int = 64,
                   batch: int = 32):
    """BASELINE config 3 as ``examples/baseline_configs.py`` ``config3``
    builds it (600 iterations or fewer): the highres128 presets, 16 MC
    ELBO and analysis samples, Adam 1e-3 halved at 400, 128 labeled, 256
    unlabeled and 64 validation fields, batch 32, no virtual observables;
    the monitor interval cut from 200 to 100 so that one monitor point
    falls inside 200 steps.  The smaller sizes are the card-vs-CPU
    check's."""
    from generative_physics_informed_pde_tpu_torch.training import (
        TrainerParameters)

    p = TrainerParameters()
    p.identifier = "highres128"
    p.margs.update(dtype=dtype)
    p.trainer.update(lr_init=1e-3, N_monitor_interval=C3_MONITOR,
                     N_monte_carlo_elbo=16, N_monte_carlo_analysis=16)
    p.scheduler = {"milestones": [400], "factor": 0.5}
    p.data.update(N_u=n_unlabeled, N_s=n_labeled, N_u_max=n_unlabeled,
                  N_s_max=n_labeled, N_vo_max=0, N_vo=0, N_val=n_val,
                  armortized_bs=batch, vo_spec={})
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


class VOChunk:
    """A trainer's 'vo' chunk with its X_DG on ``device``: what
    ``build_virtual_observables_ensemble`` reads."""

    def __init__(self, ds_vo, device):
        self.ds_vo, self.device = ds_vo, device

    def get(self, key):
        v = self.ds_vo.get(key)
        return v.to(self.device) if key == "X_DG" else v


def labeled_copies(dl, dlu):
    """Fresh loaders over a labeled pool (its labels solved once) and an
    unlabeled one, as a second process of the same run would build them."""
    from generative_physics_informed_pde_tpu_torch.data import DataLoader

    dlu2 = DataLoader(dlu.X)
    dlu2.lock_physics_assembly()
    return DataLoader(dl.X, X_DG=dl.X_DG, Y=dl.Y, BCE=dl.BCE,
                      F_ROM_BC=dl.F_ROM_BC), dlu2


def vo_k1_check(tr, n_cols):
    """K1 against the plain path at a trained trainer's VO applies
    (``apply_coeff``, ``apply_Kff`` of ``n_cols`` columns, the effective
    force), bit for bit in f32 and f64; returns K1's largest abs error."""
    import torch
    from generative_physics_informed_pde_tpu_torch.constraints import (
        QuerryPointEnsemble)
    from generative_physics_informed_pde_tpu_torch.ops import apply_stencil

    say("  K1 vs plain path at the VO shapes (apply_coeff, apply_Kff, "
        "effective_force)")
    fom_vo = tr.physics["fom"]
    ds_vo = tr.datasets["vo"]
    vgen = torch.Generator(device="cuda").manual_seed(9)
    worst = 0.0
    for dt in (torch.float32, torch.float64):
        qpe = QuerryPointEnsemble(
            fom_vo, ds_vo.get("X_DG").to(dt),
            torch.as_tensor(ds_vo.get("BCE").constrained_values("fom"),
                            dtype=dt, device="cuda"))
        V = torch.randn(qpe.N, qpe.dim_out, n_cols, generator=vgen,
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
        if apply_stencil.launches != before + n_k1 or n_k1 != 2 + n_cols:
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
    return worst


def energy_update_card_vs_cpu(tr, spec, phys_cpu, n_mc):
    """One energy update of ``spec``'s VO ensemble in f64 from the trained
    trainer's propagated moments, on the card and then on the CPU
    (``phys_cpu``) with the same injected test functions, where each of the
    CPU's subspace systems M s = r (M = V^T A V) takes the card's solution.
    The systems reach condition numbers of ~1e9 (32 overlapping RBF test
    functions of width 0.2), so two f64 solves that round differently
    differ by up to cond * eps: the card's solutions are held by their
    normwise backward error for the CPU's systems, ||M s - r|| / (||M||
    ||s|| + ||r||), which covers the right-hand sides too; the matrices,
    the updated mean and the variances entry by entry.  Returns (the
    matrices' largest relative difference, the largest backward error, the
    mean's and variances' largest relative difference, the systems' largest
    condition number)."""
    import torch
    from generative_physics_informed_pde_tpu_torch.constraints import (
        build_virtual_observables_ensemble)

    with torch.no_grad():
        Y_mean, Y_std = tr.model.propagate_vo_moments(
            tr._data_vo, tr.vo_generator, n_mc)
    G, prec = Y_mean.double(), (1.0 / Y_std ** 2).double()
    solve_ex = torch.linalg.solve_ex
    card, err = [], {"system": 0.0, "backward": 0.0, "cond": 0.0}

    def card_solve(M, r):
        s, info = solve_ex(M, r)
        card.append((M.cpu(), s.cpu(), info.cpu()))
        return s, info

    def cpu_solve(M, r):
        M_c, s, info = card[cpu_solve.calls]
        cpu_solve.calls += 1
        err["system"] = max(err["system"], rel_diff(M_c, M))
        err["cond"] = max(err["cond"], torch.linalg.cond(M).max().item())
        eta = (M @ s - r).norm(dim=(1, 2)) / (
            torch.linalg.matrix_norm(M) * s.norm(dim=(1, 2))
            + r.norm(dim=(1, 2)))
        err["backward"] = max(err["backward"], eta.max().item())
        return s, info

    cpu_solve.calls = 0
    out = {}
    for run, device, phys, solve in (("card", "cuda", tr.physics, card_solve),
                                     ("cpu", "cpu", phys_cpu, cpu_solve)):
        with injected_draws(13):
            ens = build_virtual_observables_ensemble(
                spec, VOChunk(tr.datasets["vo"], device), phys,
                dtype=torch.float64)
            torch.linalg.solve_ex = solve
            try:
                ens.update(G.to(device), prec.to(device), 0)
            finally:
                torch.linalg.solve_ex = solve_ex
        out[run] = (ens.mean.cpu(), ens.vars.cpu())
    if cpu_solve.calls != len(card) \
            or len(card) != spec["energy_num_iterations_per_update"]:
        raise AssertionError(f"the energy update solved {len(card)} and "
                             f"{cpu_solve.calls} subspace systems")
    return (err["system"], err["backward"],
            max(rel_diff(a, b) for a, b in zip(out["card"], out["cpu"])),
            err["cond"])


def vo_path_checks(tr, dl, spec, phys_cpu, n_mc):
    """Phase 4c's checks of the virtual observables of the trained
    trainer ``tr`` (its VO chunk from the labeled pool ``dl``, whose labels
    are f64): K1 against the plain path at the VO applies, bit for bit in
    f32 and f64; the constraints of ``spec`` at the f64 labels and at an
    f32 solve of them; one constrain refresh card vs CPU (``phys_cpu``) in
    f64 with the same draws.  Returns (K1's largest abs error, the f64
    labels of the VO chunk on the card)."""
    import torch
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler, build_virtual_observables_ensemble)

    worst = vo_k1_check(tr, tr.VO.m)
    fom_vo = tr.physics["fom"]
    ds_vo = tr.datasets["vo"]

    say("  constraints at the FOM labels of the VO chunk")
    Y_vo64 = torch.as_tensor(dl.Y[ds_vo.indices], device="cuda")
    X_DG_vo = ds_vo.get("X_DG")
    bc_vo = torch.as_tensor(ds_vo.get("BCE").constrained_values("fom"),
                            device="cuda")
    Y_vo32 = fom_vo.solve_batched(torch.exp(X_DG_vo).float(), bc_vo.float())
    for dname, Y_lab in (("float64", Y_vo64), ("float32", Y_vo32)):
        vo_chk = build_virtual_observables_ensemble(
            spec, ds_vo, tr.physics, dtype=getattr(torch, dname))
        G, a = vo_chk.Gamma, vo_chk.alpha
        r = (G @ Y_lab[..., None])[..., 0] - a
        lo = 0
        for smp in vo_chk.sampler.samplers:
            rs, Gs = r[:, lo:lo + smp.m], G[:, lo:lo + smp.m]
            lo += smp.m
            if isinstance(smp, FluxConstrainSampler):
                val = (rs.abs().max() / Gs.abs().sum(-1).mean()).item()
                bound = VO_FLUX_BOUND
            else:
                val = (rs.norm(dim=1) / (Gs.norm(dim=(1, 2))
                                         * Y_lab.norm(dim=1))).max().item()
                bound = VO_LABEL_RTOL[dname]
            say(f"    {dname} {type(smp).__name__} ({smp.m}): {val:.3e} "
                f"(bound {bound:g})")
            if not val <= bound:
                raise AssertionError(f"{type(smp).__name__} constraints do "
                                     f"not hold at the {dname} labels")

    say("  one constrain refresh, card vs CPU, f64, same draws (twice: the "
        "second learns the precision)")
    with torch.no_grad():
        Y_mean, Y_std = tr.model.propagate_vo_moments(
            tr._data_vo, tr.vo_generator, n_mc)
    moments = {}
    for run, device, phys in (("card", "cuda", tr.physics),
                              ("cpu", "cpu", phys_cpu)):
        with injected_draws(13):
            ens = build_virtual_observables_ensemble(
                spec, VOChunk(ds_vo, device), phys, dtype=torch.float64)
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
    return worst, Y_vo64


def gate_terms(model, data, state):
    """(bf16 term, f32 term, relative move, supervised term bit-equal) of
    ``model``'s train-mode ELBO on ``data`` from ``state``, once with the
    unlabeled codec in bf16 and once in f32, each with the same injected
    draws (and generator) and deterministic cuDNN; the model is left at
    ``state`` with the gate off."""
    import torch

    logs = {}
    device = next(model.parameters()).device
    torch.backends.cudnn.deterministic = True
    try:
        for dt in (torch.bfloat16, None):
            model.unsup_compute_dtype = dt
            model.load_state_dict(state)
            with injected_draws(21), torch.no_grad():
                _, logs[dt] = model.elbo(data, torch.Generator(
                    device).manual_seed(21))
    finally:
        torch.backends.cudnn.deterministic = False
    model.load_state_dict(state)
    on, off = logs[torch.bfloat16], logs[None]
    u_on, u_off = (on["ARM_unsupervised_elbo"].item(),
                   off["ARM_unsupervised_elbo"].item())
    return (u_on, u_off, abs(u_on - u_off) / abs(u_off),
            torch.equal(on["supervised_elbo"], off["supervised_elbo"]))


def gate_test_model():
    """On the card, the model and data of the JAX package's bf16 gate test
    (tests/test_models.py:393-463), the state its 0.2 bound was set for: a
    32^2 'NDP' pair (a 4^2 ROM refined 3 times), a decoder of latent 8 (an
    8^2 latent image of one feature, 4 initial features, blocks (1, 1),
    growth 4) and its encoder, f32, a random init from seed 0; 3 labeled
    fields (normal labels, zero forcing) and 4 unlabeled ones."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch.factories.model import (
        init_weights_)
    from generative_physics_informed_pde_tpu_torch.fem import (
        make_fom_rom_pair)
    from generative_physics_informed_pde_tpu_torch.models import (
        CNNDecoder, CNNEncoder, EffectivePropertyMap, GenerativeModel,
        ReducedOrderModelOperator)

    physics = make_fom_rom_pair("NDP", 4, 4, 3, device="cuda")
    g = ReducedOrderModelOperator.from_physics(physics)
    model = GenerativeModel(
        g=g, gp=EffectivePropertyMap(
            latent_dim=8, dim_effective_property=g.dim_effective_property),
        encoder=CNNEncoder(imsize=32, latent_dim=8, blocks=(1, 1),
                           growth_rate=4, init_features=4),
        f=CNNDecoder(target_img_size=32, dim_latent=8, latent_img_size=8,
                     latent_img_features=1, init_features=4, blocks=(1, 1),
                     growth_rate=4))
    init_weights_(model, torch.Generator().manual_seed(0))
    model.to(device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(2)

    def tensor(a):
        return torch.as_tensor(a, dtype=torch.float32, device="cuda")

    data = {"supervised": {
        "X": tensor(rng.normal(0.4, 0.8, (3, 32, 32))),
        "Y": tensor(rng.normal(size=(3, physics["fom"].dim_out))),
        "F_ROM_BC": tensor(np.zeros((3, physics["rom"].grid.n_nodes)))},
        "unsupervised": {"X": tensor(rng.normal(0.4, 0.8, (4, 32, 32)))}}
    model.init_params({"supervised": data["supervised"]})
    return model, data


def f64_steps_card_vs_cpu(what, p, dl, dlu, n):
    """Three f64 SVI steps of the recipe ``p`` with its bf16 gates, monitor
    and final refinement off, on ``n`` + ``n`` labeled fields of ``dl``
    and ``n`` unlabeled fields of ``dlu``, batch ``n``: on the card, then
    on the CPU (plain path) from the card run's initial state with the
    same draws.  Checks and returns (the ELBOs' largest relative
    difference, the parameters' and statistics')."""
    import torch
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer)

    p.margs.update(dtype="float64", unsup_compute_dtype=None)
    p.trainer.update(N_monitor_interval=0, N_PE_updates_final=0,
                     PE_compute_dtype=None)
    p.data.update(N_u=n, N_s=n, N_u_max=n, N_s_max=n, N_val=n,
                  armortized_bs=n)
    out, state = {}, None
    for run, device in (("card", "cuda"), ("cpu", "cpu")):
        tr = CreateTrainer(p, DataLoader(dl.X[:2 * n], Y=dl.Y[:2 * n],
                                         F_ROM_BC=dl.F_ROM_BC[:2 * n]),
                           DataLoader(dlu.X[:n]), device=device)
        if tr.model.unsup_compute_dtype is not None \
                or tr._PE.compute_dtype is not None:
            raise AssertionError("the f64 check runs with a bf16 gate on")
        if state is None:
            state = {k: v.detach().cpu().clone()
                     for k, v in tr.model.state_dict().items()}
        else:
            tr.model.load_state_dict(state)
        with injected_draws(13):
            for _ in range(3):
                tr.step()
        out[run] = (tr.elbos().double(),
                    {k: v.detach().cpu() for k, v in
                     tr.model.state_dict().items()})
        del tr
    err = ((out["card"][0] - out["cpu"][0]).abs()
           / out["cpu"][0].abs()).max().item()
    perr = max(rel_diff(out["card"][1][k], v) for k, v in out["cpu"][1].items()
               if v.is_floating_point() and v.numel())
    say(f"  ELBOs card {out['card'][0].tolist()} vs CPU "
        f"{out['cpu'][0].tolist()}: max rel {err:.3e} (tolerance "
        f"{SVI_CPU_RTOL:g}); parameters and statistics max rel {perr:.3e} "
        f"(tolerance {C3_PARAM_RTOL:g})")
    if not err <= SVI_CPU_RTOL or not perr <= C3_PARAM_RTOL:
        raise AssertionError(f"f64 {what} SVI steps on the card differ from "
                             "the CPU")
    return err, perr


def phase9_config3(card, gen, start_path, end_path, report_profile):
    """Phase 9: BASELINE config 3 (``examples/baseline_configs.py``
    ``config3``) on the card: the pools, the f64 MG label solve on K1 (its
    launches per V-cycle level, K1 bit-equal to the plain version on each
    level, the true residual), 200 SVI steps with the bf16 gates resolved
    on, steps/s, the device's busy share and peak memory, the bf16 gate
    against full precision at the random init, and three f64 steps card vs
    CPU.  Returns
    what phase 8 and the records read."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres128)
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil_reference)
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer)

    say(f"phase 9: BASELINE config 3 (highres128, N_monte_carlo_elbo=16, "
        f"bf16 unlabeled and PE decodes), {C3_STEPS} steps; card: {card}")
    rf3 = fem.GaussianRandomField.from_image(128, 128, 0.4, 1.0, 0.08,
                                             method="fft", kernel="matern32")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    dl_c3 = DataLoader.from_sampler(rf3, C3_LABELED, key=0, device="cuda")
    dlu_c3 = DataLoader.from_sampler(rf3, C3_UNLABELED, key=1,
                                     device="cuda")
    dlu_c3.lock_physics_assembly()
    pool_c3_s = time.perf_counter() - t0
    if dl_c3.X.shape != (C3_LABELED, 128, 128) \
            or dlu_c3.X.shape != (C3_UNLABELED, 128, 128) \
            or not (np.isfinite(dl_c3.X).all()
                    and np.isfinite(dlu_c3.X).all()):
        raise AssertionError("config 3 pools are not finite 128^2 fields")
    phys_c3 = highres128().setup(device="cuda")[0]
    fom_c3 = phys_c3["fom"]
    mg_c3 = fom_c3._batched_solver.mg
    if mg_c3 is None or mg_c3.num_levels != len(MG128_NODES):
        raise AssertionError("'auto' did not pick a 6-level V-cycle at "
                             "128^2")
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    dl_c3.assemble(phys_c3, label_batch=C3_LABEL_BATCH)
    t_e.record()
    torch.cuda.synchronize()
    c3_label_ms = t_s.elapsed_time(t_e)
    c3_label_iters = list(dl_c3.label_iterations)
    c3_label_launches = launch_counts()
    c3_rows = [r for k in c3_label_iters for r in mg_rows(
        "9 config3 train", mg_c3, MG128_NODES, C3_LABEL_BATCH, "float64", k)]
    a_c3 = torch.exp(torch.as_tensor(dl_c3.X_DG, device="cuda"))
    v_c3 = torch.as_tensor(dl_c3.BCE.constrained_values("fom"),
                           device="cuda")
    Y_c3 = torch.as_tensor(dl_c3.Y, device="cuda")
    c3_res = true_residual(fom_c3, Y_c3, a_c3, v_c3,
                           apply_stencil_reference).max().item()
    say(f"  pools drawn in {pool_c3_s:.2f} s (FFT, Matern-3/2, keys 0/1); "
        f"labels: {C3_LABELED} fields f64 in {c3_label_ms:.1f} ms "
        f"(dispatches of {C3_LABEL_BATCH}), PCG iterations "
        f"{c3_label_iters}, launches {c3_label_launches}; true relative "
        f"residual max "
        f"{c3_res:.3e} (bound {C3_RESIDUAL:g})")
    check_launches("config 3's labels", c3_label_launches, c3_rows)
    if not c3_res <= C3_RESIDUAL:
        raise AssertionError("config 3 labels exceed their residual bound")
    del v_c3, Y_c3
    t0 = time.perf_counter()
    trainer_c3 = CreateTrainer(config3_params(), dl_c3, dlu_c3,
                               device="cuda")
    setup_c3_s = time.perf_counter() - t0
    ucd, pcd = trainer_c3.model.unsup_compute_dtype, \
        trainer_c3._PE.compute_dtype
    say(f"  resolved gates: unsup_compute_dtype {ucd}, PE_compute_dtype "
        f"{pcd}; n_mc {trainer_c3.model.n_mc}")
    if ucd != torch.bfloat16 or pcd != torch.bfloat16 \
            or trainer_c3.model.n_mc != 16:
        raise AssertionError("config 3 did not resolve its bf16 gates or "
                             "its 16 MC samples")
    # the random init (seed 0): the state the gate check's bound is for
    state_init = {k: v.clone()
                  for k, v in trainer_c3.model.state_dict().items()}
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    trainer_c3.run(C3_STEPS, verbose=False)
    t_e.record()
    c3_counts = end_path("9 config3 train")
    # the V-cycle's steps on every level of the first label dispatch, bit
    # for bit (after the path: these launches are not the path's)
    vcycle_levels_check(dataclasses.replace(mg_c3, dtype="float64"),
                        a_c3[:C3_LABEL_BATCH], gen)
    say("  the V-cycle's steps bit-equal to their plain versions on the six "
        "levels of the first label dispatch")
    run_c3_s = t_s.elapsed_time(t_e) / 1e3
    elbos_c3 = trainer_c3.elbos()
    res_c3 = trainer_c3.results()
    first, last = elbos_c3[:20].mean().item(), elbos_c3[-20:].mean().item()
    say(f"  trainer set-up {setup_c3_s:.2f} s; {C3_STEPS} steps + monitor "
        f"at {C3_MONITOR} + final refinement {run_c3_s:.2f} s; launches "
        f"{c3_counts}")
    say(f"  ELBO step 0 {elbos_c3[0].item():.6g}, mean steps 0-19 "
        f"{first:.6g}, steps {C3_STEPS - 20}-{C3_STEPS - 1} {last:.6g}; "
        f"results {res_c3}")
    check_launches("the config 3 path", c3_counts, c3_rows)
    if elbos_c3.shape != (C3_STEPS,) \
            or not bool(torch.isfinite(elbos_c3).all()) or not last > first:
        raise AssertionError("the config 3 ELBO is not finite and rising")
    if not all(np.isfinite(res_c3[k]) for k in ("relerr_y", "r2_y",
                                                "logscore_y")):
        raise AssertionError(f"config 3 results() not finite: {res_c3}")
    torch.cuda.synchronize()
    c3_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    c3_peak_phase_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    c3_label_warm_ms = event_ms(lambda: dl_c3.assemble(
        phys_c3, label_batch=C3_LABEL_BATCH))
    a_c3 = a_c3[:C3_LABEL_BATCH]
    v_c3 = torch.as_tensor(dl_c3.BCE.constrained_values("fom"),
                           device="cuda")[:C3_LABEL_BATCH]
    c3_solve_ms = event_ms(lambda: fom_c3.solve_batched(a_c3, v_c3))
    say(f"  label the pool again, warm: {c3_label_warm_ms:.2f} ms through "
        f"the loader (first call {c3_label_ms:.1f} ms); one dispatch's "
        f"solve alone ({C3_LABEL_BATCH} fields on the card): "
        f"{c3_solve_ms:.2f} ms (medians of 3)")
    del a_c3, v_c3

    def c3_steps(n):
        for _ in range(n):
            trainer_c3.step()

    c3_steps(3)
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    c3_steps(20)
    t_e.record()
    torch.cuda.synchronize()
    c3_step_ms = t_s.elapsed_time(t_e) / 20
    say(f"  SVI steps (f32; 128 labeled x 16 samples, batch 32 in bf16, PE "
        f"every 8th in bf16): {1e3 / c3_step_ms:.3f} steps/s over 20 steps "
        f"(CUDA events); peak memory {c3_peak_gb:.2f} GB allocated "
        f"({c3_peak_phase_gb:.2f} GB above the phase's start); card: "
        f"{card}")
    busy_c3 = report_profile("5 config 3 SVI steps", lambda: c3_steps(5),
                             5 * c3_step_ms)

    say("  bf16 gates on vs off: one train-mode ELBO, same draws; config "
        "3 at its trained state (reported) and twice at its random init, the "
        "JAX gate test's model twice at its random init (checked)")
    m_c3 = trainer_c3.model
    state_c3 = {k: v.clone() for k, v in m_c3.state_dict().items()}
    d_c3 = {"supervised": trainer_c3._data_sup,
            "unsupervised": {"X": trainer_c3._X_unsup[:32]}}
    gate = {"trained": gate_terms(m_c3, d_c3, state_c3),
            "init": [gate_terms(m_c3, d_c3, state_init) for _ in range(2)]}
    m_c3.unsup_compute_dtype = torch.bfloat16
    m_c3.load_state_dict(state_c3)
    del state_init, state_c3
    m_t, d_t = gate_test_model()
    state_t = {k: v.clone() for k, v in m_t.state_dict().items()}
    gate["test"] = [gate_terms(m_t, d_t, state_t) for _ in range(2)]
    del m_t, d_t, state_t
    for what, runs in (("config 3, trained state", [gate["trained"]]),
                       ("config 3, random init", gate["init"]),
                       ("the JAX gate test's model, random init",
                        gate["test"])):
        say(f"    {what}: unlabeled term bf16 {[r[0] for r in runs]} vs "
            f"f32 {[r[1] for r in runs]}: rel {runs[0][2]:.3e}; supervised "
            f"term bit-equal {[r[3] for r in runs]}")
        if not all(np.isfinite(r[0]) and np.isfinite(r[1]) and r[3]
                   for r in runs):
            raise AssertionError(f"{what}: the gate terms are not finite or "
                                 "the bf16 gate leaks into the supervised "
                                 "term")
        if runs[0] != runs[-1]:
            raise AssertionError(f"{what}: the gate check is not "
                                 "deterministic")
    u_rel = gate["test"][0][2]
    say(f"    bound {C3_BF16_RTOL:g} at the random inits: the JAX gate "
        f"test's model {u_rel:.3e}, config 3 {gate['init'][0][2]:.3e}; the "
        "trained state reported only")
    if not (u_rel <= C3_BF16_RTOL and gate["init"][0][2] <= C3_BF16_RTOL):
        raise AssertionError("the bf16 gate moves the unlabeled term too far "
                             "at a random init")

    say("  3 f64 SVI steps at the highres128 widths, card vs CPU (plain "
        "path), 8 + 8 fields, 16 MC samples, bf16 gates off, same draws")
    err, perr = f64_steps_card_vs_cpu("config 3", config3_params(), dl_c3,
                                      dlu_c3, 8)

    return {"label_iterations": c3_label_iters, "mg": mg_c3,
            "label_ms": c3_label_ms, "label_warm_ms": c3_label_warm_ms,
            "solve_ms": c3_solve_ms,
            "label_launches": c3_label_launches,
            "label_residual": c3_res, "steps_per_s": 1e3 / c3_step_ms,
            "busy_share": busy_c3, "peak_gb": c3_peak_gb,
            "peak_gb_above_start": c3_peak_phase_gb,
            "unsup_bf16_rel": u_rel,
            "unsup_bf16_rel_config3": {"trained": gate["trained"][2],
                                       "init": gate["init"][0][2]},
            "card_vs_cpu_elbo_rel": err,
            "card_vs_cpu_param_rel": perr, "results": res_c3,
            "loaders": (dl_c3, dlu_c3)}


def torch_runner():
    """``examples/torch_baseline_configs.py`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_baseline_configs", ROOT / "examples" / "torch_baseline_configs.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner_recipe(drv, which):
    """What the runner's config ``which`` hands to ``_loaders`` and
    ``_run`` (both replaced by recorders for the call): the parameters,
    the random field and the pool sizes."""
    rec = {}
    loaders, run = drv._loaders, drv._run

    def rec_loaders(rf, n_labeled, n_unlabeled, seed=0, device="cuda"):
        rec.update(rf=rf, pools=(n_labeled, n_unlabeled, seed))
        return None, None

    def rec_run(params, dl, dlu, iterations, ckpt_dir=None, seg=None,
                device="cuda"):
        rec.update(params=params, iterations=iterations)

    drv._loaders, drv._run = rec_loaders, rec_run
    try:
        drv.CONFIGS[which]()
    finally:
        drv._loaders, drv._run = loaders, run
    return rec


def _state_leaves(tr):
    """(name, tensor) of a trainer's model state, Adam state and training
    generator."""
    out = [(f"model/{k}", v) for k, v in tr.model.state_dict().items()]
    for i, st in tr.optimizer.state_dict()["state"].items():
        out += [(f"adam/{i}/{k}", v) for k, v in st.items()]
    return out + [("generator", tr.generator.get_state())]


def phase10_persistence(card, c3, start_path, end_path, report_profile):
    """Phase 10: persistence and the BASELINE runner on the card.  (a)
    config 3 resumed from a checkpoint against an unbroken run, with the
    checkpoint's size and save / restore times; (b) its surrogate exported
    and loaded on the card, predicting bit for bit as the in-memory bundle
    at buckets 8, 64 and 512; (c) the metrics file against the in-memory
    scalars; (d) config 2 through the runner with phase 4c's checks.  Cut
    (see the constants): config 3's monitor every 5 steps, its final
    refinement 1 x 3 PE updates and its runs 10 + 10 against 20 steps;
    config 2 150 of its 3000 steps with its VO holdoff 25 instead of 250.
    Everything is written under a temporary directory outside the repo,
    removed at the end.  Returns what phase 8 and the records read."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)
    from generative_physics_informed_pde_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    drv = torch_runner()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase10_")
    out = {}
    try:
        # ------------------------------------------- (a) config 3 resumed
        K = C3_RESUME_K
        say(f"phase 10: persistence and the BASELINE runner; (a) config 3 "
            f"resumed: {K} steps + checkpoint, a fresh trainer restores and "
            f"runs {K} more, against {2 * K} unbroken; card: {card}")
        rec3 = runner_recipe(drv, "3")
        p3 = rec3["params"]
        if rec3["pools"] != (C3_LABELED, C3_UNLABELED, 0) \
                or p3.trainer["N_monte_carlo_elbo"] != 16:
            raise AssertionError(f"the runner's config 3 is not phase 9's: "
                                 f"{rec3['pools']}, {p3.trainer}")
        p3.trainer.update(N_monitor_interval=C3_RESUME_MONITOR,
                          N_PE_updates_final=1)
        # phase 9's pools are the fields the runner's ``_loaders`` draws
        # (the same field, keys, sizes)
        dl9, dlu9 = c3["loaders"]

        ckpt_dir = os.path.join(tmp, "config3_ckpt")
        ckpt = os.path.join(ckpt_dir, drv.CHECKPOINT)
        torch.backends.cudnn.deterministic = True
        try:
            t0 = time.perf_counter()
            tr_a = drv._run(p3, *labeled_copies(dl9, dlu9), K,
                            ckpt_dir=ckpt_dir, seg=K, device="cuda")
            seg_a_s = time.perf_counter() - t0
            if tr_a.gn != K or not os.path.isfile(ckpt):
                raise AssertionError("the first segment wrote no checkpoint")
            del tr_a
            p3.folder = os.path.join(tmp, "logs")  # part (c)
            t0 = time.perf_counter()
            tr_b = drv._run(p3, *labeled_copies(dl9, dlu9), 2 * K,
                            ckpt_dir=ckpt_dir, seg=K, device="cuda")
            seg_b_s = time.perf_counter() - t0
            p3.folder = None
            t0 = time.perf_counter()
            tr_u = drv._run(p3, *labeled_copies(dl9, dlu9), 2 * K,
                            device="cuda")
            unbroken_s = time.perf_counter() - t0
        finally:
            torch.backends.cudnn.deterministic = False
        if tr_b.gn != 2 * K or tr_b.elbos().shape != (K,):
            raise AssertionError("the resumed run did not restore at "
                                 f"gn={K} and run {K} steps")
        leaves_b, leaves_u = _state_leaves(tr_b), _state_leaves(tr_u)
        if [n for n, _ in leaves_b] != [n for n, _ in leaves_u]:
            raise AssertionError("the resumed and unbroken states differ in "
                                 "structure")
        differ = [n for (n, a), (_, b) in zip(leaves_b, leaves_u)
                  if not torch.equal(a, b)]
        elbo_equal = torch.equal(tr_b.elbos(), tr_u.elbos()[K:])
        worst = max((rel_diff(a.double(), b.double())
                     for (n, a), (_, b) in zip(leaves_b, leaves_u)
                     if n in differ and a.is_floating_point()), default=0.0)
        say(f"  segments {seg_a_s:.2f} s + {seg_b_s:.2f} s, unbroken "
            f"{unbroken_s:.2f} s; resumed vs unbroken: {len(leaves_b)} "
            f"tensors (parameters, BatchNorm statistics, posteriors, Adam, "
            f"generator), {len(differ)} not bit-equal (max rel {worst:.3e}); "
            f"ELBOs of steps {K}-{2 * K - 1} bit-equal: {elbo_equal}; "
            f"monitor points resumed {tr_b._monitor['elbo_iter']}, unbroken "
            f"{tr_u._monitor['elbo_iter']}")
        if differ:
            say(f"  not bit-equal: {differ[:10]}")
            for (n, a), (_, b) in zip(leaves_b, leaves_u):
                if n in differ and not torch.allclose(
                        a.double(), b.double(), rtol=RESUME_RTOL,
                        atol=RESUME_ATOL):
                    raise AssertionError(f"the resumed run's {n} differs from "
                                         "the unbroken run's")
        if not differ and not elbo_equal:
            raise AssertionError("bit-equal states after different ELBOs")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr_b.save_checkpoint(os.path.join(tmp, "timed.pt"))
        save_ms = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        tr_u.restore_checkpoint(os.path.join(tmp, "timed.pt"))
        torch.cuda.synchronize()
        restore_ms = 1e3 * (time.perf_counter() - t0)
        ckpt_mb = os.path.getsize(ckpt) / 1e6
        say(f"  checkpoint {ckpt_mb:.3f} MB; save {save_ms:.2f} ms, restore "
            f"{restore_ms:.2f} ms (host clock, synchronised); card: {card}")
        out["resume"] = dict(bit_equal=not differ, not_bit_equal=differ,
                             max_rel=worst, checkpoint_mb=ckpt_mb,
                             save_ms=save_ms, restore_ms=restore_ms)
        del tr_u

        # --------------------------------------------- (b) export, load
        say("  (b) export the resumed trainer's surrogate, load it on the "
            "card, predict at each bucket")
        path = os.path.join(tmp, "surrogate.zip")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle = tr_b.export_surrogate(path)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = SurrogateBundle.load(path, device="cuda")
        load_s = time.perf_counter() - t0
        n_req = max(bundle.buckets)
        rows = np.arange(n_req) % dl9.N  # the pool's fields, repeated
        xs = torch.as_tensor(dl9.X[rows], dtype=torch.float32, device="cuda")
        fs = torch.as_tensor(dl9.F_ROM_BC[rows], dtype=torch.float32,
                             device="cuda")
        predict = {}
        for b in bundle.buckets:
            got, want = loaded.predict(xs[:b], fs[:b]), \
                bundle.predict(xs[:b], fs[:b])
            if got.shape != (b, tr_b.physics["fom"].dim_out) \
                    or not bool(torch.isfinite(got).all()) \
                    or not torch.equal(bits(got), bits(want)):
                raise AssertionError(f"the loaded bundle's bucket {b} is not "
                                     "bit-equal to the in-memory bundle")
            predict[b] = (cuda_time_ms(lambda: loaded.predict(xs[:b], fs[:b]),
                                       20),
                          cuda_time_ms(lambda: bundle.predict(xs[:b], fs[:b]),
                                       20))
        say(f"  bundle {os.path.getsize(path) / 1e6:.2f} MB: export "
            f"{export_s:.2f} s, load {load_s:.2f} s; bit-equal at buckets "
            f"{list(bundle.buckets)}; predict ms loaded / in-memory "
            + ", ".join(f"{b}: {a:.3f} / {m:.3f}"
                        for b, (a, m) in predict.items()) + f"; card: {card}")
        out["export"] = dict(export_s=export_s, load_s=load_s,
                             bundle_mb=os.path.getsize(path) / 1e6,
                             predict_ms={str(b): t[0]
                                         for b, t in predict.items()},
                             in_memory_predict_ms={str(b): t[1] for b, t
                                                   in predict.items()})
        del bundle, loaded, xs, fs

        # ------------------------------------------------ (c) metrics file
        tr_b.finalize()
        with open(tr_b.writer.path) as fh:
            lines = [json.loads(line) for line in fh]
        # repr: a NaN scalar (JSON's NaN token) compares equal to itself
        got = sorted(repr((d["tag"], d["step"], d["value"])) for d in lines
                     if "tag" in d)
        want = sorted(repr((t, s_, v)) for t, pairs in
                      tr_b.writer.scalars.items() for s_, v in pairs)
        nan_tags = sorted({t for t, pairs in tr_b.writer.scalars.items()
                           for _, v in pairs if v != v})
        say(f"  (c) metrics file {os.path.basename(tr_b.writer.path)}: "
            f"{len(got)} scalar lines equal to the in-memory scalars: "
            f"{got == want} (NaN-valued tags: {nan_tags}); last line "
            f"hparams: {'hparams' in lines[-1]}")
        if got != want or not got or "hparams" not in lines[-1]:
            raise AssertionError("the metrics file differs from the "
                                 "in-memory scalars")
        # phase 17 exports the resumed trainer's surrogate for two platforms
        out["resumed"] = tr_b
        del tr_b

        # ---------------------------------------- (d) config 2, the runner
        say(f"  (d) BASELINE config 2 through the runner ('highres' 64^2, "
            f"constrain VO on {C2_VO} fields), {C2_STEPS} steps, VO holdoff "
            f"{C2_HOLDOFF}")
        rec2 = runner_recipe(drv, "2")
        p2 = rec2["params"]
        if rec2["pools"] != (3 * C2_VO, 1024, 0) \
                or p2.data["N_vo"] != C2_VO \
                or p2.trainer["N_monte_carlo_vo"] != 64 \
                or p2.data["vo_spec"]["type"] != "constrain":
            raise AssertionError(f"the runner's config 2 changed: "
                                 f"{rec2['pools']}, {p2.data}")
        p2.trainer["N_vo_holdoff"] = C2_HOLDOFF
        start_path()
        t0 = time.perf_counter()
        dl2, dlu2 = drv._loaders(rec2["rf"], *rec2["pools"][:2],
                                 seed=rec2["pools"][2], device="cuda")
        torch.cuda.synchronize()
        pool_s = time.perf_counter() - t0
        # the refreshes, read at the trainer's class: the runner builds it
        refreshes2 = []
        refresh = Trainer.update_virtual_observables

        def counted_refresh(self, step, resample=True):
            refreshes2.append(step)
            return refresh(self, step, resample)

        # per step, the VO terms the first refresh switches on (the
        # y-likelihood and, with independent_X, the X terms), kept on the
        # device: the held-off ELBO is the total without them
        switched = []
        step = Trainer.step

        def logged_step(self):
            logs = step(self)
            switched.append(sum(
                torch.as_tensor(logs.get(k, 0.0), dtype=logs["elbo"].dtype,
                                device=logs["elbo"].device)
                for k in ("vo_logL_y", "vo_logL_X", "vo_entropy_X")))
            return logs

        Trainer.update_virtual_observables = counted_refresh
        Trainer.step = logged_step
        t0 = time.perf_counter()
        try:
            tr2 = drv._run(p2, dl2, dlu2, C2_STEPS, device="cuda")
            torch.cuda.synchronize()
        finally:
            Trainer.update_virtual_observables = refresh
            Trainer.step = step
        run2_s = time.perf_counter() - t0
        counts2 = end_path("10d config2")
        mg2 = tr2.physics["fom"]._batched_solver.mg
        iters2 = list(dl2.label_iterations)
        k1_per_assembly2 = sum(smp.m + 1 for smp in tr2.VO.sampler.samplers
                               if not isinstance(smp, FluxConstrainSampler))
        failures2 = tr2.writer.scalars.get(
            "Monitor/VO_conditioning_failures", [])
        rows2 = [r for k in iters2 for r in mg_rows(
            "10d config2", mg2, MG_NODES, C2_LABEL_BATCH, "float64", k)]
        rows2.append(("10d config2", "apply_stencil", MG_NODES[0], C2_VO,
                      "float32", k1_per_assembly2 * (1 + len(refreshes2))))
        elbos2 = tr2.elbos().double()
        vo_on = torch.stack(switched).double().cpu()
        held = elbos2 - vo_on
        res2 = tr2.results()
        first, last = held[:20].mean().item(), held[-20:].mean().item()
        entered = elbos2[C2_HOLDOFF:C2_HOLDOFF + 20].mean().item()
        last_total = elbos2[-20:].mean().item()
        say(f"  pools (FFT, keys 0/1) {pool_s:.2f} s; labels, set-up, "
            f"{C2_STEPS} steps and the final refinement {run2_s:.2f} s; "
            f"label PCG iterations {iters2} (V-cycle of {mg2.num_levels} "
            f"levels, dispatches of {C2_LABEL_BATCH}); m = {tr2.VO.m} "
            f"({[(type(x).__name__, x.m) for x in tr2.VO.sampler.samplers]},"
            f" {k1_per_assembly2} K1 a constraint assembly); refreshes at "
            f"{refreshes2}; conditioning failures {failures2}; launches "
            f"{counts2}")
        say(f"  ELBO every 10 steps {[f'{v:.4g}' for v in elbos2[::10]]}; "
            f"its VO terms switched on at the first refresh "
            f"{[f'{v:.4g}' for v in vo_on[::10]]}")
        say(f"  ELBO without them (the held-off objective) mean steps 0-19 "
            f"{first:.6g}, steps {C2_STEPS - 20}-{C2_STEPS - 1} {last:.6g}; "
            f"the whole ELBO mean steps {C2_HOLDOFF}-{C2_HOLDOFF + 19} "
            f"{entered:.6g}, steps {C2_STEPS - 20}-{C2_STEPS - 1} "
            f"{last_total:.6g}; results {res2}")
        if mg2 is None or mg2.num_levels != len(MG_NODES):
            raise AssertionError("config 2's labels did not run the "
                                 "5-level V-cycle")
        if refreshes2 != C2_REFRESHES:
            raise AssertionError(f"config 2 refreshed at {refreshes2}")
        check_launches("config 2", counts2, rows2)
        if failures2:
            raise AssertionError(f"config 2 conditioning failures "
                                 f"{failures2}")
        # the whole ELBO changes its terms at the first refresh (step
        # C2_HOLDOFF), so each rise is taken over one objective: the
        # held-off ELBO over the run, the whole ELBO after the refresh
        if elbos2.shape != (C2_STEPS,) or vo_on.shape != (C2_STEPS,) \
                or not bool(torch.isfinite(elbos2).all()) \
                or not last > first or not last_total > entered:
            raise AssertionError("config 2's ELBO is not finite and rising")
        if not all(np.isfinite(res2[k]) for k in ("relerr_y", "r2_y",
                                                  "logscore_y")):
            raise AssertionError(f"config 2 results() not finite: {res2}")
        fom2, rom2 = tr2.physics["fom"], tr2.physics["rom"]
        worst_k1, _ = vo_path_checks(
            tr2, dl2, p2.data["vo_spec"],
            fem.make_fom_rom_pair(
                fom2.physics_id, rom2.grid.nx, rom2.grid.ny,
                int(np.log2(fom2.grid.nx // rom2.grid.nx)), device="cpu"),
            p2.trainer["N_monte_carlo_vo"])

        def steps(n):
            for _ in range(n):
                tr2.step()

        steps(3)
        gn0 = tr2.gn
        t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t_s.record()
        steps(50)
        t_e.record()
        torch.cuda.synchronize()
        step2_ms = t_s.elapsed_time(t_e) / 50
        n_ref = sum(1 for g in range(gn0, gn0 + 50) if g % 50 == 0)
        n_mc = p2.trainer["N_monte_carlo_vo"]
        with torch.no_grad():
            prop_ms = event_ms(lambda: tr2.model.propagate_vo_moments(
                tr2._data_vo, tr2.vo_generator, n_mc))
            Y_mean, Y_std = tr2.model.propagate_vo_moments(
                tr2._data_vo, tr2.vo_generator, n_mc)
            resample_ms = event_ms(lambda: tr2.VO.resample(tr2.vo_generator))
            cond_ms = event_ms(lambda: tr2.VO.update(
                Y_mean, 1.0 / Y_std ** 2, tr2.gn))
        refresh_ms = event_ms(lambda: tr2.update_virtual_observables(tr2.gn))
        say(f"  {1e3 / step2_ms:.3f} SVI steps/s over 50 steps ({n_ref} "
            f"refresh among them; CUDA events); refresh {refresh_ms:.2f} ms: "
            f"propagation ({C2_VO} x {n_mc} ROM solves) {prop_ms:.2f} ms, "
            f"resampling ({k1_per_assembly2} K1 launches) {resample_ms:.2f} "
            f"ms, conditioning {cond_ms:.2f} ms (medians of 3); card: {card}")
        busy2 = report_profile(f"{C2_PROFILED_STEPS} config 2 SVI steps",
                               lambda: steps(C2_PROFILED_STEPS),
                               C2_PROFILED_STEPS * step2_ms)
        out["config2"] = dict(
            label_iterations=iters2, mg=mg2, refreshes=refreshes2,
            k1_per_assembly=k1_per_assembly2, k1_worst_abs=worst_k1,
            steps_per_s=1e3 / step2_ms, busy_share=busy2,
            refresh_ms=refresh_ms, propagation_ms=prop_ms,
            resample_ms=resample_ms, conditioning_ms=cond_ms,
            results=res2)
        del tr2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")
    return out


def phase11_config5(card, start_path, end_path, report_profile):
    """Phase 11: BASELINE config 5 (``examples/baseline_configs.py``
    ``config5``: ``examples/torch_uncertainty_study.py`` with 4096 fields
    a case) on the card.  The runner's study module sweeps 16,384 64^2
    f32 fields in one batched solve under the fused V-cycle, cold and then
    warm with fresh fields (seed 1): seconds and solves/s on the host
    clock after the moments reach the host, PCG iterations, K1 launches
    per level, the warm sweep's device busy share and peak memory.  Then
    its checks (see the C5_* constants) and a ParameterStudy of the four
    cases saved to a temporary directory and loaded back.  Returns what
    phase 8 and the records read."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil_reference)
    from generative_physics_informed_pde_tpu_torch.utils import (
        ParameterStudy, StopWatch)

    t_phase = time.perf_counter()
    us = torch_runner().torch_uncertainty_study
    if len(us.CORRLENGTHS) != C5_CASES:
        raise AssertionError(f"the study sweeps {len(us.CORRLENGTHS)} cases")
    say(f"phase 11: BASELINE config 5, the uncertainty sweep: "
        f"{C5_CASES} correlation lengths x {C5_B} fields of {C5_N}^2 f32 in "
        f"one batched solve of {C5_SYSTEMS}; card: {card}")
    phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(
        C5_N, C5_N), device="cuda")
    mg = phys._batched_solver.mg
    if mg is None or mg.num_levels != len(MG_NODES):
        raise AssertionError("'auto' did not pick the 5-level V-cycle")

    def sweep(seed):
        return us.qoi_sweep(phys, us.CORRLENGTHS, C5_B, n=C5_N, seed=seed,
                            device="cuda")

    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    runs = {}
    start_path()
    for what, seed in (("cold", 0), ("warm", 1)):
        sw = StopWatch(start=True)
        out = {k: v.cpu().numpy() for k, v in sweep(seed).items()}
        runs[what] = {"s": sw.stop(), "iterations": phys.last_iterations,
                      "out": out}
    counts = end_path("11 config5 sweep")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_above_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    for what, r in runs.items():
        say(f"  {what}: {r['s']:.3f} s, {C5_SYSTEMS / r['s']:.0f} solves/s, "
            f"{r['iterations']} PCG iterations")
    say(f"  launches {counts}; peak memory {peak_gb:.2f} GB allocated "
        f"({peak_above_gb:.2f} GB above the phase's start)")
    check_launches("the config 5 sweep", counts, [
        row for r in runs.values() for row in mg_rows(
            "11 config5 sweep", mg, MG_NODES, C5_SYSTEMS, "float32",
            r["iterations"])])
    busy = report_profile("warm config 5 sweep", lambda: sweep(1),
                          1e3 * runs["warm"]["s"])

    say("  checks: the warm sweep's fields solved again, every residual, "
        "f64 on the card and the CPU, the moments")
    fields = us.sample_fields(us.CORRLENGTHS, C5_B, n=C5_N, seed=1,
                              device="cuda")
    bc = us.centre_bc_values(phys, C5_SYSTEMS)
    alphas, Y = us.solve_systems(phys, fields, bc)
    q = us.centre_qoi(phys, Y, bc)
    res = torch.cat([true_residual(phys, Y[i:i + C5_SLICE],
                                   alphas[i:i + C5_SLICE], bc[i:i + C5_SLICE],
                                   apply_stencil_reference)
                     for i in range(0, C5_SYSTEMS, C5_SLICE)])
    max_res = res.max().item()
    say(f"  true relative residual of all {res.numel()} systems: max "
        f"{max_res:.3e} (bound {F32_FLOOR:g})")
    if res.numel() != C5_SYSTEMS or not bool((res <= F32_FLOOR).all()):
        raise AssertionError("a config 5 system's residual exceeds the f32 "
                             "floor")
    del Y, alphas, res
    idx = (torch.arange(C5_CASES)[:, None] * C5_B
           + torch.arange(C5_CHECK)).ravel()
    f64 = fields[idx.cuda()].double()
    q64 = {}
    for device in ("cuda", "cpu"):
        ph = phys if device == "cuda" else fem.LinearEllipticPhysics(
            "fom", "ND", fem.StructuredTriGrid(C5_N, C5_N), device="cpu")
        q64[device] = us.solve_qoi(ph, f64.to(device), us.centre_bc_values(
            ph, len(idx), torch.float64)).cpu()
    e64 = ((q64["cuda"] - q64["cpu"]).abs() / q64["cpu"].abs()).max().item()
    e32 = ((q[idx.cuda()].double().cpu() - q64["cpu"]).abs()
           / q64["cpu"].abs()).max().item()
    say(f"  {len(idx)} fields in f64: QOI card vs CPU max rel {e64:.3e} "
        f"(tolerance {C5_F64_RTOL:g}); f32 sweep vs f64 max rel {e32:.3e} "
        f"(tolerance {F32_FLOOR:g})")
    if not e64 <= C5_F64_RTOL or not e32 <= F32_FLOOR:
        raise AssertionError("config 5's f64 QOI differ between card and "
                             "CPU, or the f32 sweep's from them")
    qn = q.double().cpu().numpy().reshape(C5_CASES, C5_B)
    ref = {"mean": qn.mean(1), "std": qn.std(1),
           "p5": np.percentile(qn, 5, axis=1),
           "p95": np.percentile(qn, 95, axis=1)}
    got = runs["warm"]["out"]
    moment_err = max(float(np.max(np.abs(got[k] - v) / np.abs(v)))
                     for k, v in ref.items())
    for i, l in enumerate(us.CORRLENGTHS):
        say(f"    l={l}: mean {got['mean'][i]:.6f} std {got['std'][i]:.6f} "
            f"p5 {got['p5'][i]:.6f} p95 {got['p95'][i]:.6f}")
    say(f"  moments vs numpy f64 of the gathered QOI: max rel "
        f"{moment_err:.3e} (tolerance {C5_MOMENT_RTOL:g})")
    if not all(np.isfinite(v).all() and v.shape == (C5_CASES,)
               for r in runs.values() for v in r["out"].values()) \
            or not moment_err <= C5_MOMENT_RTOL:
        raise AssertionError("config 5's moments are not finite or differ "
                             "from numpy's")
    if not (np.all((got["mean"] > 0.2) & (got["mean"] < 0.8))
            and np.all(got["std"] > 0) and np.all(got["p5"] < got["p95"])):
        raise AssertionError(f"config 5's moments are degenerate: {got}")
    study = us.build_study(got)
    tmp = tempfile.mkdtemp()
    try:
        study.save(f"{tmp}/{us.STUDY_FILE}")
        back = ParameterStudy.load(f"{tmp}/{us.STUDY_FILE}")
    finally:
        shutil.rmtree(tmp)
    if {k: back.get(k) for k in back.keys()} \
            != {k: study.get(k) for k in study.keys()}:
        raise AssertionError("the config 5 study does not load back equal")
    del fields, bc, q, f64
    phase_s = time.perf_counter() - t_phase
    say(f"  study of {len(study.keys())} cases saved and loaded back equal; "
        f"phase 11 {phase_s:.1f} s")
    return {"mg": mg, "iterations": {k: r["iterations"]
                                     for k, r in runs.items()},
            "seconds": {k: r["s"] for k, r in runs.items()},
            "solves_per_s": {k: C5_SYSTEMS / r["s"] for k, r in runs.items()},
            "launches": counts,
            "busy_share": busy, "peak_gb": peak_gb,
            "peak_gb_above_start": peak_above_gb,
            "max_true_residual": max_res, "f64_card_vs_cpu_rel": e64,
            "f32_vs_f64_rel": e32, "moments_vs_numpy_rel": moment_err,
            "moments": {k: v.tolist() for k, v in got.items()},
            "phase_s": phase_s}


def label_pool(dl, phys, nodes, label_batch, path):
    """Label the pool ``dl`` with the physics' 'auto' solve (its V-cycle of
    ``len(nodes)`` levels) in the loader's dispatches of ``label_batch``:
    (ms by CUDA events, PCG iterations per dispatch, the derived launches
    of ``path``'s labels (``mg_rows``, checked against the counted ones),
    the f64 true relative residual's max over the pool, the first
    dispatch's conductivities)."""
    import torch
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil_reference)

    fom = phys["fom"]
    mg = fom._batched_solver.mg
    if mg is None or mg.num_levels != len(nodes):
        raise AssertionError(f"'auto' did not pick a {len(nodes)}-level "
                             f"V-cycle at {nodes[0]} nodes a side")
    before = launch_counts()
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    dl.assemble(phys)
    t_e.record()
    torch.cuda.synchronize()
    iters = list(dl.label_iterations)
    rows = [r for k in iters for r in mg_rows(path, mg, nodes, label_batch,
                                              "float64", k)]
    if dl.label_batch != label_batch:
        raise AssertionError(f"the loader labeled in dispatches of "
                             f"{dl.label_batch}")
    check_launches(f"{path}'s labels", {
        k: n - before[k] for k, n in launch_counts().items()}, rows)
    a = torch.exp(torch.as_tensor(dl.X_DG, device="cuda"))
    v = torch.as_tensor(dl.BCE.constrained_values("fom"), device="cuda")
    res = max(true_residual(fom, torch.as_tensor(dl.Y[i:i + label_batch],
                                                 device="cuda"),
                            a[i:i + label_batch], v[i:i + label_batch],
                            apply_stencil_reference).max().item()
              for i in range(0, dl.N, label_batch))
    return t_s.elapsed_time(t_e), iters, rows, res, a[:label_batch]


def check_run(what, tr, steps, plans):
    """A runner's trainer after ``steps`` steps: every step's ELBO and the
    final metrics finite, and the validation analyses' Monte-Carlo plans
    ``{S: (chunk, n_chunks)}`` the JAX package's."""
    import numpy as np
    import torch

    elbos = tr.elbos()
    res = tr.results()
    got = {S: tr._analysis.mc_chunks.get(("y", S)) for S in plans}
    say(f"  {what}: ELBO every 10 steps "
        f"{[f'{v:.4g}' for v in elbos[::10].tolist()]}; results {res}; "
        f"Monte-Carlo plans (chunk, n_chunks) by S {got}, S_eff "
        f"{ {S: c[0] * c[1] for S, c in got.items() if c} } (the JAX "
        f"package's {plans})")
    if elbos.shape != (steps,) or not bool(torch.isfinite(elbos).all()):
        raise AssertionError(f"{what}: an ELBO is not finite")
    if not all(np.isfinite(res[k]) for k in ("relerr_y", "r2_y",
                                             "logscore_y")):
        raise AssertionError(f"{what}: results() not finite: {res}")
    if got != plans:
        raise AssertionError(f"{what}: the analyses sampled {got}, the JAX "
                             f"package {plans}")
    return res


@contextlib.contextmanager
def vo_failures_watched(dump=None):
    """Within: the virtual observables' containment warnings recorded, not
    shown, in the list yielded as (failed samples, iteration) per failing
    update when the block ends (other warnings shown then); ``dump``: each
    failing update's inputs written there (``GPIPDE_VO_DUMP``)."""
    import os
    import re
    import warnings

    saved = os.environ.get("GPIPDE_VO_DUMP")
    if dump is not None:
        os.environ["GPIPDE_VO_DUMP"] = str(dump)
    failed = []
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield failed
    finally:
        if saved is None:
            os.environ.pop("GPIPDE_VO_DUMP", None)
        else:
            os.environ["GPIPDE_VO_DUMP"] = saved
        for w in caught:
            m = re.search(r"non-finite moments for (\d+)/\d+ samples at "
                          r"iteration (\d+)", str(w.message))
            if m:
                failed.append((int(m[1]), int(m[2])))
            else:
                warnings.warn_explicit(w.message, w.category, w.filename,
                                       w.lineno)


def timed_steps(tr, n, warm=3):
    """ms a step of ``n`` steps after ``warm`` (CUDA events)."""
    import torch

    for _ in range(warm):
        tr.step()
    t_s, t_e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t_s.record()
    for _ in range(n):
        tr.step()
    t_e.record()
    torch.cuda.synchronize()
    return t_s.elapsed_time(t_e) / n


def phase12_config4(card, gen, start_path, end_path, report_profile):
    """Phase 12: BASELINE config 4 through the runner on the card (see the
    C4_* constants): the pools (10,240 unlabeled 256^2 fields), the f64
    labels under the 7-level V-cycle on K1, C4_STEPS steps with a monitor
    point and the final analysis, steps/s, busy share, peak memory; then
    three f64 steps card vs CPU at the full widths.  Returns what phase 8
    and the records read."""
    import torch
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres128)

    t_phase = time.perf_counter()
    drv = torch_runner()
    rec = runner_recipe(drv, "4")
    p = rec["params"]
    if rec["pools"] != C4_POOLS \
            or p.margs.get("num_refines") != len(MG256_NODES) - 2:
        raise AssertionError(f"the runner's config 4 changed: {rec['pools']}, "
                             f"{p.margs}, {p.data}")
    p.trainer.update(N_monitor_interval=C4_MONITOR,
                     N_PE_updates_final=C4_PE_FINAL)
    say(f"phase 12: BASELINE config 4 through the runner (8^2 ROM, "
        f"{MG256_NODES[0] - 1}^2 FOM, {C4_POOLS[0]} labeled + {C4_POOLS[1]} "
        f"unlabeled fields), {C4_STEPS} steps, monitor at {C4_MONITOR}; "
        f"card: {card}")
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start_path()
    t0 = time.perf_counter()
    dl, dlu = drv._loaders(rec["rf"], *rec["pools"][:2], seed=rec["pools"][2],
                           device="cuda")
    pool_s = time.perf_counter() - t0
    phys = highres128(**p.margs).setup(device="cuda")[0]
    label_ms, iters, rows, res, a0 = label_pool(dl, phys, MG256_NODES,
                                                C4_LABEL_BATCH, "12 config4")
    t0 = time.perf_counter()
    tr = drv._run(p, dl, dlu, C4_STEPS, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = end_path("12 config4")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    peak_above_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    say(f"  pools (FFT, keys 0/1) {pool_s:.2f} s ({dlu.X.nbytes / 1e9:.2f} "
        f"GB of f64 unlabeled fields on the host); labels {dl.N} fields f64 "
        f"in {label_ms:.1f} ms, PCG iterations {iters} (dispatches of "
        f"{C4_LABEL_BATCH}), true relative "
        f"residual max {res:.3e} (bound {C3_RESIDUAL:g}); set-up, "
        f"{C4_STEPS} steps, monitor and final analysis {run_s:.2f} s; "
        f"launches {counts}; peak {peak_gb:.2f} GB allocated "
        f"({peak_above_gb:.2f} above the phase's start)")
    check_launches("the config 4 path", counts, rows)
    vcycle_levels_check(dataclasses.replace(
        phys["fom"]._batched_solver.mg, dtype="float64"), a0, gen)
    say(f"  the V-cycle's steps bit-equal to their plain versions on the "
        f"{len(MG256_NODES)} levels of the first label dispatch")
    del a0
    if not res <= C3_RESIDUAL:
        raise AssertionError("config 4 labels exceed their residual bound")
    results = check_run("config 4", tr, C4_STEPS, C4_MC_PLANS)
    step_ms = timed_steps(tr, 10)
    say(f"  {1e3 / step_ms:.3f} SVI steps/s over 10 steps (CUDA events; "
        f"64 labeled, batch 32 in bf16, PE every 8th); card: {card}")
    busy = report_profile("5 config 4 SVI steps", lambda: timed_steps(
        tr, 5, 0), 5 * step_ms)
    del tr

    say(f"  3 f64 SVI steps at config 4's widths, card vs CPU (plain path), "
        f"{C4_CPU_FIELDS} + {C4_CPU_FIELDS} fields, bf16 gates off, same "
        "draws")
    err, perr = f64_steps_card_vs_cpu("config 4", runner_recipe(
        drv, "4")["params"], dl, dlu, C4_CPU_FIELDS)
    del dl, dlu
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 12 took {phase_s:.1f} s")
    return {"label_iterations": iters, "mg": phys["fom"]._batched_solver.mg,
            "label_ms": label_ms, "launches": counts,
            "label_residual": res, "pool_s": pool_s,
            "steps_per_s": 1e3 / step_ms, "busy_share": busy,
            "peak_gb": peak_gb, "peak_gb_above_start": peak_above_gb,
            "card_vs_cpu_elbo_rel": err, "card_vs_cpu_param_rel": perr,
            "results": results, "phase_s": phase_s}


def phase13_config512(card, gen, start_path, end_path, report_profile):
    """Phase 13: BASELINE config 512 through the runner's ``_run`` on the
    card (see the C512_* constants): the pools, the f64 labels under the
    8-level V-cycle on K1, two checkpointed segments (the second resumes
    from the first's checkpoint in a temporary directory), steps/s, and
    the final analysis's peak memory streamed (as the run does) and in one
    shot, then three f64 steps card vs CPU on C512_CPU_FIELDS fields.
    Returns what phase 8 and the records read."""
    import os
    import shutil
    import tempfile

    import torch
    from generative_physics_informed_pde_tpu_torch.factories import (
        highres128)
    from generative_physics_informed_pde_tpu_torch.inference import analysis

    t_phase = time.perf_counter()
    drv = torch_runner()
    rec = runner_recipe(drv, "512")
    p = rec["params"]
    if rec["pools"] != C512_POOLS \
            or p.margs.get("num_refines") != len(MG512_NODES) - 2:
        raise AssertionError(f"the runner's config 512 changed: "
                             f"{rec['pools']}, {p.margs}, {p.data}")
    p.trainer.update(N_monitor_interval=C512_MONITOR, N_PE_updates_final=1)
    say(f"phase 13: BASELINE config 512 through the runner ("
        f"{MG512_NODES[0] - 1}^2 FOM, {C512_POOLS[0]} labeled + "
        f"{C512_POOLS[1]} unlabeled fields), two segments of {C512_SEG} "
        f"steps, the second resumed from the first's checkpoint; card: "
        f"{card}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase13_")
    try:
        ckpt_dir = os.path.join(tmp, "config512_ckpt")
        ckpt = os.path.join(ckpt_dir, drv.CHECKPOINT)
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start_path()
        t0 = time.perf_counter()
        dl, dlu = drv._loaders(rec["rf"], *rec["pools"][:2],
                               seed=rec["pools"][2], device="cuda")
        pool_s = time.perf_counter() - t0
        phys = highres128(**p.margs).setup(device="cuda")[0]
        label_ms, iters, rows, res, a0 = label_pool(
            dl, phys, MG512_NODES, C512_LABEL_BATCH, "13 config512")
        t0 = time.perf_counter()
        tr_a = drv._run(p, dl, dlu, C512_SEG, ckpt_dir=ckpt_dir,
                        seg=C512_SEG, device="cuda")
        seg_a_s = time.perf_counter() - t0
        if tr_a.gn != C512_SEG or not os.path.isfile(ckpt):
            raise AssertionError("the first segment wrote no checkpoint")
        check_run("config 512, first segment", tr_a, C512_SEG,
                  C512_MC_PLANS)
        del tr_a
        t0 = time.perf_counter()
        tr = drv._run(p, *labeled_copies(dl, dlu), 2 * C512_SEG,
                      ckpt_dir=ckpt_dir, seg=C512_SEG, device="cuda")
        torch.cuda.synchronize()
        seg_b_s = time.perf_counter() - t0
        counts = end_path("13 config512")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        peak_above_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        say(f"  pools (FFT, keys 0/1) {pool_s:.2f} s; labels {dl.N} fields "
            f"f64 in {label_ms:.1f} ms, PCG iterations {iters} (dispatches "
            f"of {C512_LABEL_BATCH}), true "
            f"relative residual max {res:.3e} (bound {C3_RESIDUAL:g}); "
            f"segments {seg_a_s:.2f} s + {seg_b_s:.2f} s (set-up, steps, "
            f"monitor, checkpoint, final analysis); resumed at gn "
            f"{tr.gn - len(tr.elbos())}, monitor points "
            f"{tr._monitor['elbo_iter']}; launches {counts}; peak "
            f"{peak_gb:.2f} GB allocated ({peak_above_gb:.2f} above the "
            f"phase's start)")
        check_launches("the config 512 path", counts, rows)
        vcycle_levels_check(dataclasses.replace(
            phys["fom"]._batched_solver.mg, dtype="float64"), a0, gen)
        say(f"  the V-cycle's steps bit-equal to their plain versions on "
            f"the {len(MG512_NODES)} levels of the first label dispatch")
        del a0
        if not res <= C3_RESIDUAL:
            raise AssertionError("config 512 labels exceed their residual "
                                 "bound")
        if tr.gn != 2 * C512_SEG or tr.elbos().shape != (C512_SEG,):
            raise AssertionError(f"the resumed run did not restore at gn="
                                 f"{C512_SEG} and run {C512_SEG} steps")
        results = check_run("config 512, resumed segment", tr, C512_SEG,
                            C512_MC_PLANS)
        step_ms = timed_steps(tr, 5)
        say(f"  {1e3 / step_ms:.3f} SVI steps/s over 5 steps (CUDA events; "
            f"64 labeled, batch 16 in bf16, PE every 8th); card: {card}")
        busy = report_profile("3 config 512 SVI steps", lambda: timed_steps(
            tr, 3, 0), 3 * step_ms)

        say("  the final analysis (S = 128 over 32 fields of 512^2): peak "
            "memory streamed, as the run does, and in one shot")
        n_final = tr.get("N_monte_carlo_analysis_final")
        analysis_gb, analysis_ms = {}, {}
        budget = analysis._EVAL_ELEMENT_BUDGET
        try:
            for how, b in (("streamed", budget), ("one shot", 2 ** 62)):
                analysis._EVAL_ELEMENT_BUDGET = b
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                t_s, t_e = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                t_s.record()
                out = tr._analysis.eval_all_y(
                    tr._PE.q, tr._monitor_generator(17), n_final)
                t_e.record()
                torch.cuda.synchronize()
                analysis_ms[how] = t_s.elapsed_time(t_e)
                analysis_gb[how] = (torch.cuda.max_memory_allocated()
                                    - base) / 1e9
                say(f"    {how}: plan {tr._analysis.mc_chunks['y', n_final]}"
                    f", {analysis_gb[how]:.2f} GB above the trainer's "
                    f"{base / 1e9:.2f} GB, {analysis_ms[how]:.1f} ms; "
                    f"(logscore, R^2, rel-L2) {out}")
                if not all(torch.isfinite(torch.tensor(out))):
                    raise AssertionError(f"the {how} 512^2 analysis is not "
                                         "finite")
        finally:
            analysis._EVAL_ELEMENT_BUDGET = budget
        del tr
        say(f"  3 f64 SVI steps at config 512's widths (the 513^2 FOM and "
            f"its {len(MG512_NODES)}-level V-cycle built on each side), card "
            f"vs CPU (plain path), {C512_CPU_FIELDS} + {C512_CPU_FIELDS} "
            "fields, bf16 gates off, same draws")
        t0 = time.perf_counter()
        err, perr = f64_steps_card_vs_cpu("config 512", runner_recipe(
            drv, "512")["params"], dl, dlu, C512_CPU_FIELDS)
        cpu_check_s = time.perf_counter() - t0
        say(f"  the f64 check took {cpu_check_s:.1f} s (card and CPU); "
            f"card: {card}")
        del dl, dlu
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 13 took {phase_s:.1f} s")
    return {"label_iterations": iters, "mg": phys["fom"]._batched_solver.mg,
            "label_ms": label_ms, "launches": counts,
            "label_residual": res, "pool_s": pool_s,
            "segment_s": [seg_a_s, seg_b_s], "steps_per_s": 1e3 / step_ms,
            "busy_share": busy, "peak_gb": peak_gb,
            "peak_gb_above_start": peak_above_gb,
            "final_analysis_gb": analysis_gb,
            "final_analysis_ms": analysis_ms, "results": results,
            "card_vs_cpu_elbo_rel": err, "card_vs_cpu_param_rel": perr,
            "card_vs_cpu_s": cpu_check_s, "phase_s": phase_s}


def phase14_vo_configs(card, start_path, end_path, report_profile):
    """Phase 14: BASELINE configs 2e, 2h and 2he through the runner on
    the card (see the VO_* constants): per config the pools, the f64
    labels under the V-cycle on K1, the cut run with its refreshes or
    energy updates on K1, the checks (K1 against the plain path at the VO
    shapes; 2h's constraints at the labels; one refresh or energy update
    card vs CPU in f64) and the times of a step, a refresh and its parts;
    the VO conditioning failures over the run and the timing block (the
    ``Monitor/VO_conditioning_failures`` series and the containment
    warning; config 2h's failing inputs dumped if one occurs) reported,
    and the stored moments finite after them.
    Returns {config: what phase 8 and the records read}."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler)
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil, apply_stencil_reference)
    from generative_physics_informed_pde_tpu_torch.training import Trainer

    t_phase = time.perf_counter()
    drv = torch_runner()
    say(f"phase 14: BASELINE configs {', '.join(VO_CONFIGS)} through the "
        f"runner (virtual observables on {C2_VO} fields: energy at 64^2, "
        f"constrain and energy at 128^2); card: {card}")
    out = {}
    for c in VO_CONFIGS:
        rec = runner_recipe(drv, c)
        p = rec["params"]
        spec = p.data["vo_spec"]
        energy = spec["type"] == "energy"
        if rec["pools"] != VO_POOLS or p.data["N_vo"] != C2_VO \
                or p.trainer["N_monte_carlo_vo"] != 64:
            raise AssertionError(f"the runner's config {c} changed: "
                                 f"{rec['pools']}, {p.data}")
        steps = VO_STEPS[c]
        p.trainer.update(N_vo_holdoff=VO_HOLDOFF,
                         N_PE_updates_final=VO_PE_FINAL)
        say(f"  ({c}) {p.identifier}, {spec['type']} VO, {steps} steps, "
            f"holdoff {VO_HOLDOFF}, every "
            f"{p.trainer.get('N_vo_update_interval', 50)} steps")
        refreshes = []
        refresh = Trainer.update_virtual_observables

        def counted_refresh(self, step, resample=True):
            refreshes.append(step)
            return refresh(self, step, resample)

        dump = None
        if c == VO_DUMP_CONFIG:
            dump = VO_DUMP
            dump.parent.mkdir(parents=True, exist_ok=True)
            dump.unlink(missing_ok=True)
        start_path()
        t0 = time.perf_counter()
        dl, dlu = drv._loaders(rec["rf"], *rec["pools"][:2],
                               seed=rec["pools"][2], device="cuda")
        torch.cuda.synchronize()
        pool_s = time.perf_counter() - t0
        Trainer.update_virtual_observables = counted_refresh
        t0 = time.perf_counter()
        try:
            with vo_failures_watched(dump) as run_failed:
                tr = drv._run(p, dl, dlu, steps, device="cuda")
                torch.cuda.synchronize()
        finally:
            Trainer.update_virtual_observables = refresh
        run_s = time.perf_counter() - t0
        counts = end_path(f"14 config{c}")
        fom = tr.physics["fom"]
        mg = fom._batched_solver.mg
        iters = list(dl.label_iterations)
        levels = MG_NODES if fom.grid.nx + 1 == MG_NODES[0] \
            else MG128_NODES
        rows = [r for k in iters for r in mg_rows(
            f"14 config{c}", mg, levels, dl.label_batch, "float64", k)]
        if energy:
            # per update: each subspace iteration applies K_ff to its test
            # columns and to the iterate, then one effective force
            per_refresh = spec["energy_num_iterations_per_update"] \
                * (spec["N_rbf"] + 1) + 1
            vo_launches = per_refresh * len(refreshes)
        else:  # one assembly at set-up and one a refresh
            per_refresh = sum(smp.m + 1 for smp in tr.VO.sampler.samplers
                              if not isinstance(smp, FluxConstrainSampler))
            vo_launches = per_refresh * (1 + len(refreshes))
        label_batch = dl.label_batch
        a = torch.exp(torch.as_tensor(dl.X_DG, device="cuda"))
        v = torch.as_tensor(dl.BCE.constrained_values("fom"), device="cuda")
        res = max(true_residual(fom, torch.as_tensor(
            dl.Y[i:i + label_batch], device="cuda"), a[i:i + label_batch],
            v[i:i + label_batch], apply_stencil_reference).max().item()
            for i in range(0, dl.N, label_batch))
        del a, v
        say(f"    pools (FFT, keys 0/1) {pool_s:.2f} s; labels, set-up, "
            f"{steps} steps and the final refinement {run_s:.2f} s; label "
            f"PCG iterations {iters} (V-cycle of {mg.num_levels} levels), "
            f"true relative residual max {res:.3e} (bound "
            f"{C3_RESIDUAL:g}); refreshes at {refreshes} ({per_refresh} K1 "
            f"launches each{'' if energy else ', and one assembly at set-up'}"
            f"); launches {counts}")
        if refreshes != VO_REFRESHES[c]:
            raise AssertionError(f"config {c} refreshed at {refreshes}")
        rows.append((f"14 config{c}", "apply_stencil", fom.grid.nx + 1,
                     C2_VO, "float32", vo_launches))
        check_launches(f"config {c}", counts, rows)
        if not res <= C3_RESIDUAL:
            raise AssertionError(f"config {c} labels exceed their residual "
                                 "bound")
        results = check_run(f"config {c}", tr, steps,
                            {tr.get("N_monte_carlo_analysis_final"):
                             VO_MC_PLAN})
        rom = tr.physics["rom"]
        phys_cpu = fem.make_fom_rom_pair(
            fom.physics_id, rom.grid.nx, rom.grid.ny,
            int(np.log2(fom.grid.nx // rom.grid.nx)), device="cpu")
        n_mc = p.trainer["N_monte_carlo_vo"]
        if energy:
            worst = vo_k1_check(tr, spec["N_rbf"])
            say("  one energy update, card vs CPU, f64, same draws, the "
                "CPU's subspace systems solved by the card's solutions")
            *errs, cond = energy_update_card_vs_cpu(tr, spec, phys_cpu,
                                                    n_mc)
            err = max(errs)
            say(f"    subspace matrices max rel {errs[0]:.3e} (condition "
                f"number max {cond:.3e}), the card's solutions' backward "
                f"error for them max {errs[1]:.3e}, mean and vars max rel "
                f"{errs[2]:.3e} (tolerance {VO_CPU_RTOL:g} each)")
            if not err <= VO_CPU_RTOL:
                raise AssertionError(f"config {c}'s energy update on the "
                                     "card differs from the CPU")
        else:
            worst, _ = vo_path_checks(tr, dl, spec, phys_cpu, n_mc)
        with vo_failures_watched(dump) as timing_failed:
            step_ms = timed_steps(tr, 10)
            with torch.no_grad():
                prop_ms = event_ms(lambda: tr.model.propagate_vo_moments(
                    tr._data_vo, tr.vo_generator, n_mc))
                Y_mean, Y_std = tr.model.propagate_vo_moments(
                    tr._data_vo, tr.vo_generator, n_mc)
                before = apply_stencil.launches
                torch.cuda.synchronize()
                t_s, t_e = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                t_s.record()
                tr.VO.resample(tr.vo_generator)
                tr.VO.update(Y_mean, 1.0 / Y_std ** 2, tr.gn,
                             writer=tr.writer)
                t_e.record()
                torch.cuda.synchronize()
                update_launches = apply_stencil.launches - before
                update_ms = event_ms(lambda: (
                    tr.VO.resample(tr.vo_generator),
                    tr.VO.update(Y_mean, 1.0 / Y_std ** 2, tr.gn,
                                 writer=tr.writer)))
            refresh_ms = event_ms(
                lambda: tr.update_virtual_observables(tr.gn))
        series = [(int(it), int(n)) for it, n in tr.writer.scalars.get(
            "Monitor/VO_conditioning_failures", [])]
        finite = bool(torch.isfinite(tr.VO.mean).all()
                      and torch.isfinite(tr.VO.vars).all())
        say(f"    VO conditioning failures ((failed samples, iteration) an "
            f"update, of {tr.VO.N}): the run {run_failed}, its timing block "
            f"{timing_failed}; the writer's series (iteration, failed) "
            f"{series}; stored moments finite: {finite}"
            + (f"; inputs dumped to {dump.relative_to(ROOT)}"
               if dump is not None and dump.is_file() else ""))
        if not finite:
            raise AssertionError(f"config {c}: the VO moments are not "
                                 "finite after the containment")
        say(f"    {1e3 / step_ms:.3f} SVI steps/s over 10 steps (CUDA "
            f"events); refresh {refresh_ms:.2f} ms: propagation ({C2_VO} x "
            f"{n_mc} ROM solves) {prop_ms:.2f} ms, "
            f"{'energy update' if energy else 'resampling + conditioning'} "
            f"({update_launches} K1 launches at "
            f"{(fom.grid.ny + 1, fom.grid.nx + 1, C2_VO)} f32) "
            f"{update_ms:.2f} ms (medians of 3); card: {card}")
        if update_launches != per_refresh:
            raise AssertionError(f"a config {c} refresh launched K1 "
                                 f"{update_launches} times")
        busy = report_profile(f"3 config {c} SVI steps", lambda: timed_steps(
            tr, 3, 0), 3 * step_ms)
        out[c] = dict(label_iterations=iters, mg=mg, label_batch=label_batch,
                      nodes=fom.grid.nx + 1, refreshes=refreshes,
                      k1_per_refresh=per_refresh, energy=energy,
                      k1_worst_abs=worst, label_residual=res,
                      vo_card_vs_cpu_rel=err if energy else None,
                      steps_per_s=1e3 / step_ms, busy_share=busy,
                      refresh_ms=refresh_ms, propagation_ms=prop_ms,
                      update_ms=update_ms, results=results,
                      vo_failures=run_failed + timing_failed)
        del tr, dl, dlu
        torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 14 took {phase_s:.1f} s")
    return out


class injected_analysis_draws(injected_draws):
    """``injected_draws`` plus the analyses' own standard normals (the
    ROM's reparametrised draws and the decodes' noise), from the same
    numpy stream in call order."""

    def __enter__(self):
        import torch
        from generative_physics_informed_pde_tpu_torch.inference import (
            analysis)

        super().__enter__()
        rng = self.rng

        def standard_normal(shape, like, generator=None):
            return torch.as_tensor(rng.standard_normal(tuple(shape)),
                                   dtype=like.dtype, device=like.device)

        extra = ((analysis, "standard_normal", standard_normal),)
        self.saved += [getattr(m, n) for m, n, _ in extra]
        self.targets += extra
        for m, n, f in extra:
            setattr(m, n, f)
        return self


def phase15_api(card, start_path, end_path, report_profile):
    """Phase 15: the rest of the public API on the card, at the highres32
    and 'highres' widths.  (a) Single-system solves (``fom.solve``, K1 at
    (33,33,1) and (65,65,1)) of 8 labeled highres32 fields in f64 against
    the batched labels and the dense direct solve, their VJPs against the
    batched solve's VJP and a central difference on 2 cells, 2 'highres'
    64^2 fields against the direct solve, one f32 solve's true residual.
    (b) ``solve_batched_vmap`` on the 1024 fields, f64 and f32, against
    the single solves, ``solve_batched`` and the residual floor, timed
    beside ``solve_batched``.  (c) A source and a top flux through
    ``solve_full`` against the dense solve.  (d) ROM calibration at the
    JAX defaults on the 1024 f64 labels, card against CPU, and the
    Galerkin oracle.  (e) ``DenseED`` at its class defaults on 64 fields
    of 64^2, card against CPU f64.  (f) The highres32 preset's dataset
    cache in a temporary directory outside the repo.  (g)
    ``Analysis.from_encoder`` + ``eval_all`` at the seed-0 init, card
    against CPU f64 under injected draws.  The device's busy share of one
    single solve and of 5 calibration steps under the profiler.  Returns
    (derived launches
    [(path, kernel, nodes, B, dtype, launches)], records)."""
    import shutil
    import tempfile
    import warnings

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.factories import (
        data as data_presets, highres, highres32)
    from generative_physics_informed_pde_tpu_torch.factories.model import (
        init_weights_)
    from generative_physics_informed_pde_tpu_torch.inference.analysis \
        import Analysis
    from generative_physics_informed_pde_tpu_torch.models import (
        DenseED, ReducedOrderModelOperator, optimize_effective_properties,
        reduced_order_model_solve)
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil_reference)

    t_phase = time.perf_counter()
    say("phase 15: the rest of the API on the card (single-system solves, "
        "vmap solves, forcing, calibration, DenseED, dataset cache, "
        "analysis)")
    derived, rec = [], {}
    with np.load(LABELED) as data:
        X = np.array(data["X"])
    N = X.shape[0]
    phys = highres32().physics(device="cuda")
    fom = phys["fom"]
    bce = fem.BoundaryConditionEnsemble.from_factory(
        "NDP", N, np.random.default_rng(15))
    bce.register_function_space("fom", fom.grid)
    bce.register_function_space("rom", phys["rom"].grid)
    a64 = torch.exp(fom.pixels.image_to_function(
        torch.as_tensor(X, device="cuda")))
    v64 = torch.as_tensor(bce.constrained_values("fom"), device="cuda")
    Y_batched = fom.solve_batched(a64, v64)
    w = torch.randn(P15_SINGLE, fom.dim_out, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(15)).cuda()

    # ------------------------------------------------ (a) single solves
    start_path()
    singles, grads, iters, adj = [], [], [], []
    for i in range(P15_SINGLE):
        singles.append(fom.solve(a64[i], v64[i]))
        iters.append(fom._solver.iterations)
    for i in range(P15_SINGLE):
        a = a64[i].clone().requires_grad_()
        v = v64[i].clone().requires_grad_()
        f = torch.zeros(fom.grid.n_nodes, dtype=torch.float64,
                        device="cuda", requires_grad=True)
        y = fom.solve(a, v, f)
        iters.append(fom._solver.iterations)
        grads.append(torch.autograd.grad((w[i] * y).sum(), (a, f, v)))
        adj.append(fom._solver.adjoint_iterations)
    hr_phys = highres().physics(device="cuda")
    hr_fom = hr_phys["fom"]
    rf = fem.GaussianRandomField.from_image(64, 64, 0.4, 0.8, 0.04,
                                            method="fft")
    X_hr = rf.sample(torch.Generator(device="cuda").manual_seed(15),
                     batch_size=2, dtype=torch.float64, device="cuda")
    a_hr = torch.exp(hr_fom.pixels.image_to_function(X_hr))
    v_hr = torch.as_tensor(hr_fom.profile.constrained_values(
        np.random.default_rng(16).normal(size=(2, 4))), device="cuda")
    hr_singles, hr_iters = [], []
    for i in range(2):
        hr_singles.append(hr_fom.solve(a_hr[i], v_hr[i]))
        hr_iters.append(hr_fom._solver.iterations)
    y32 = fom.solve(a64[0].float(), v64[0].float())
    iters32 = fom._solver.iterations
    counts = end_path("15a single solves")
    if counts["apply_stencil"] == 0:
        raise AssertionError("the single solves launched K1 0 times")
    derived += [("15a single solves", "apply_stencil", 33, 1, "float64",
                 k + 1) for k in iters + adj]
    derived += [("15a single solves", "apply_stencil", 65, 1, "float64",
                 k + 1) for k in hr_iters]
    derived.append(("15a single solves", "apply_stencil", 33, 1, "float32",
                    iters32 + 1))
    Ys = torch.stack(singles)
    err_b = rel_diff(Ys, Y_batched[:P15_SINGLE])
    err_d = max(
        np.abs(Ys[i].cpu().numpy() - fom.solve_direct(
            a64[i].cpu().numpy(), v64[i].cpu().numpy())).max()
        / np.abs(Ys[i].cpu().numpy()).max() for i in range(P15_SINGLE))
    say(f"  {P15_SINGLE} f64 single solves at (33,33,1), {iters[:P15_SINGLE]}"
        f" PCG iterations: vs solve_batched {err_b:.3e} (bound "
        f"{P15_BATCHED_RTOL:g}), vs the dense direct solve {err_d:.3e} "
        f"(bound {DIRECT_RTOL:g})")
    if not (err_b <= P15_BATCHED_RTOL and err_d <= DIRECT_RTOL):
        raise AssertionError("single solves disagree with the batched or "
                             "direct solve")
    # the VJP against the batched solve's on the same 8 fields
    ab = a64[:P15_SINGLE].clone().requires_grad_()
    vb = v64[:P15_SINGLE].clone().requires_grad_()
    gb = torch.autograd.grad((w * fom.solve_batched(ab, vb)).sum(), (ab, vb))
    err_ga = rel_diff(torch.stack([g[0] for g in grads]), gb[0])
    err_gv = rel_diff(torch.stack([g[2] for g in grads]), gb[1])
    # a central difference along 2 cells, on a solver to 1e-13
    tight = fem.make_fom_solver(fom.op, fom.profile.free_mask, tol=FD_TOL)
    bc0 = fom.profile.scatter_full(v64[0])
    zero = torch.zeros_like(bc0)
    fd_err = 0.0
    # the two cells of the largest sensitivity
    for c in grads[0][0].abs().topk(2).indices.tolist():
        e = torch.zeros_like(a64[0])
        e[c] = FD_STEP * a64[0, c]
        lp = (w[0] * fom.profile.restrict_free(tight(a64[0] + e, zero, bc0))
              ).sum()
        lm = (w[0] * fom.profile.restrict_free(tight(a64[0] - e, zero, bc0))
              ).sum()
        fd = float(lp - lm) / (2 * float(e[c]))
        fd_err = max(fd_err, abs(fd - float(grads[0][0][c])) / abs(fd))
    say(f"  VJPs (adjoint iterations {adj}): alpha vs the batched VJP "
        f"{err_ga:.3e}, bc {err_gv:.3e} (bound {P15_BATCHED_RTOL:g}); "
        f"central difference on 2 cells {fd_err:.3e} (bound "
        f"{VJP_FD_RTOL:g}); f-cotangent finite: "
        f"{all(bool(torch.isfinite(g[1]).all()) for g in grads)}")
    if not (err_ga <= P15_BATCHED_RTOL and err_gv <= P15_BATCHED_RTOL
            and fd_err <= VJP_FD_RTOL
            and all(bool(torch.isfinite(g[1]).all()) for g in grads)):
        raise AssertionError("single-solve VJP disagrees")
    err_hr = max(
        np.abs(hr_singles[i].cpu().numpy() - hr_fom.solve_direct(
            a_hr[i].cpu().numpy(), v_hr[i].cpu().numpy())).max()
        / np.abs(hr_singles[i].cpu().numpy()).max() for i in range(2))
    res32 = true_residual(fom, y32[None], a64[:1].float(),
                          v64[:1].float(), apply_stencil_reference)
    say(f"  'highres' 64^2 f64 single solves at (65,65,1), {hr_iters} "
        f"iterations: vs the direct solve {err_hr:.3e} (bound "
        f"{DIRECT_RTOL:g}); f32 single solve: {iters32} iterations, "
        f"true relative residual {float(res32[0]):.3e} (bound "
        f"{F32_FLOOR:g})")
    if not (err_hr <= DIRECT_RTOL and float(res32[0]) <= F32_FLOOR):
        raise AssertionError("'highres' or f32 single solve off")
    single_ms = {"float64": event_ms(lambda: fom.solve(a64[0], v64[0])),
                 "float32": event_ms(lambda: fom.solve(a64[0].float(),
                                                       v64[0].float()))}
    say(f"  one single solve: f64 {single_ms['float64']:.2f} ms, f32 "
        f"{single_ms['float32']:.2f} ms (CUDA events, median of 3)")
    busy_single = report_profile(
        "one f64 single solve", lambda: fom.solve(a64[0], v64[0]),
        single_ms["float64"])
    rec["single"] = dict(iterations_f64=iters[:P15_SINGLE],
                         adjoint_iterations=adj, iterations_f32=iters32,
                         highres_iterations=hr_iters, ms=single_ms,
                         vs_batched=err_b, vs_direct=err_d,
                         vjp_vs_batched=max(err_ga, err_gv),
                         vjp_vs_fd=fd_err, highres_vs_direct=err_hr,
                         f32_residual=float(res32[0]),
                         busy_share=busy_single)

    # --------------------------------------- (b) vmap on the 1024 fields
    a32, v32 = a64.float(), v64.float()
    start_path()
    Yv64 = fom.solve_batched_vmap(a64, v64)
    it64 = fom._solver.iterations
    Yv32 = fom.solve_batched_vmap(a32, v32)
    it32 = fom._solver.iterations
    counts = end_path("15b vmap solves")
    if counts["apply_stencil"] == 0:
        raise AssertionError("the vmap solves launched K1 0 times")
    derived += [("15b vmap solves", "apply_stencil", 33, N, "float64",
                 int(it64.max()) + 1),
                ("15b vmap solves", "apply_stencil", 33, N, "float32",
                 int(it32.max()) + 1)]
    err_vs = rel_diff(Yv64[:P15_SINGLE], Ys)
    err_vb = rel_diff(Yv64, Y_batched)
    res_v32 = true_residual(fom, Yv32, a32, v32, apply_stencil_reference)
    say(f"  f64: per-system iterations {int(it64.min())}..."
        f"{int(it64.max())}; rows vs the single solves {err_vs:.3e} (bound "
        f"{P15_SINGLE_RTOL:g}), vs solve_batched {err_vb:.3e} (bound "
        f"{P15_BATCHED_RTOL:g}); f32 ({int(it32.min())}...{int(it32.max())} "
        f"iterations): true relative residual max "
        f"{float(res_v32.max()):.3e} (bound {F32_FLOOR:g})")
    if not (err_vs <= P15_SINGLE_RTOL and err_vb <= P15_BATCHED_RTOL
            and bool((res_v32 <= F32_FLOOR).all())):
        raise AssertionError("solve_batched_vmap disagrees")
    vmap_ms = {}
    for name, (a, v) in (("float64", (a64, v64)), ("float32", (a32, v32))):
        vmap_ms[name] = (event_ms(lambda: fom.solve_batched_vmap(a, v)),
                         event_ms(lambda: fom.solve_batched(a, v)))
        say(f"  {name} 1024 fields: solve_batched_vmap "
            f"{vmap_ms[name][0]:.2f} ms, solve_batched "
            f"{vmap_ms[name][1]:.2f} ms, ratio "
            f"{vmap_ms[name][0] / vmap_ms[name][1]:.3f} (medians of 3)")
    rec["vmap"] = dict(iterations_f64=[int(it64.min()), int(it64.max())],
                       iterations_f32=[int(it32.min()), int(it32.max())],
                       ms={k: dict(vmap=t[0], batched=t[1])
                           for k, t in vmap_ms.items()},
                       vs_single=err_vs, vs_batched=err_vb,
                       f32_residual=float(res_v32.max()))

    # ------------------------------------------------------- (c) forcing
    grid = fom.grid
    gen = torch.Generator().manual_seed(17)
    src = torch.randn(grid.n_cells, dtype=torch.float64, generator=gen)
    flux = torch.randn(len(grid.boundary_nodes("top")) - 1,
                       dtype=torch.float64, generator=gen)
    f_full = (fem.volume_force(grid, src.cuda())
              + fem.neumann_force(grid, "top", flux.cuda()))
    start_path()
    y_f = fom.solve_full(a64[0], v64[0], f_full)
    it_f = fom._solver.iterations
    counts = end_path("15c forcing")
    derived.append(("15c forcing", "apply_stencil", 33, 1, "float64",
                    it_f + 1))
    K = fem.dense_stiffness(grid, a64[0].cpu().numpy())
    free, con = fom.free_dofs, fom.constrained_dofs
    vals0 = v64[0].cpu().numpy()
    want = np.zeros(grid.n_nodes)
    want[con] = vals0
    want[free] = np.linalg.solve(
        K[np.ix_(free, free)],
        f_full.cpu().numpy()[free] - K[np.ix_(free, con)] @ vals0)
    err_f = np.abs(y_f.cpu().numpy() - want).max() / np.abs(want).max()
    say(f"  a DG0 source plus a top flux through solve_full ({it_f} "
        f"iterations, {counts['apply_stencil']} K1 launches): vs the dense "
        f"f64 solve {err_f:.3e} (bound {DIRECT_RTOL:g})")
    if not err_f <= DIRECT_RTOL:
        raise AssertionError("forced solve disagrees with the dense solve")
    rec["forcing"] = dict(iterations=it_f, vs_dense=err_f)

    # --------------------------------------------------- (d) calibration
    F_rom = torch.as_tensor(np.array(bce.full_f_with_applied_bc("rom")))
    g_card = ReducedOrderModelOperator.from_physics(phys).double().cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lx, Yp, obj = optimize_effective_properties(g_card, Yv64, F_rom.cuda())
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    g_cpu = ReducedOrderModelOperator.from_physics(
        highres32().physics(device="cpu")).double()
    t0 = time.perf_counter()
    lx_cpu, _, obj_cpu = optimize_effective_properties(g_cpu, Yv64.cpu(),
                                                       F_rom)
    cal_cpu_s = time.perf_counter() - t0
    busy_cal = report_profile(
        "5 calibration steps", lambda: optimize_effective_properties(
            g_card, Yv64, F_rom.cuda(), num_iterations=5),
        1e3 * cal_s * 5 / len(obj))
    err_lx = rel_diff(lx.cpu(), lx_cpu)
    relerr = float(((Yp - Yv64).norm(dim=1) / Yv64.norm(dim=1)).mean())
    X_dg = fom.pixels.image_to_function(torch.as_tensor(X[:4])).numpy()
    Y_rom = reduced_order_model_solve(fom, np.asarray(phys["W"]), X_dg,
                                      v64[:4].cpu().numpy())
    Y_fine = np.stack([fom.solve_direct(np.exp(X_dg[n]),
                                        v64[n].cpu().numpy())
                       for n in range(4)])
    rom_err = float(np.linalg.norm(Y_rom - Y_fine) / np.linalg.norm(Y_fine))
    say(f"  calibration of {N} fields ({len(obj)} Adam steps, lr 1e-2): "
        f"objective {obj[0]:.4e} -> {obj[-1]:.4e}, final mean relative "
        f"error {relerr:.4f}; {cal_s:.2f} s on the card, {cal_cpu_s:.2f} s "
        f"on the CPU; logX card vs CPU {err_lx:.3e} (bound "
        f"{P15_CAL_RTOL:g}); Galerkin ROM oracle vs the direct solve on 4 "
        f"fields {rom_err:.4f} (bound {P15_ROM_BOUND:g})")
    if not (obj[-1] < obj[0] and err_lx <= P15_CAL_RTOL
            and rom_err < P15_ROM_BOUND):
        raise AssertionError("calibration failed its checks")
    rec["calibration"] = dict(objective=[obj[0], obj[-1]], relerr=relerr,
                              seconds=cal_s, cpu_seconds=cal_cpu_s,
                              card_vs_cpu=err_lx, rom_oracle_relerr=rom_err,
                              busy_share=busy_cal)

    # -------------------------------------------------------- (e) DenseED
    ed = init_weights_(DenseED(out_channels=2, blocks=P15_ED_BLOCKS),
                       torch.Generator().manual_seed(15)).cuda()
    x_ed = torch.randn(P15_ED_FIELDS, 64, 64, 1,
                       generator=torch.Generator().manual_seed(18)).cuda()
    ed.train()
    out_tr = ed(x_ed)
    out_tr.square().mean().backward()
    ed.eval()
    with torch.no_grad():
        out_ev = ed(x_ed)
    ed.train()

    def fwd_bwd():
        ed.zero_grad(set_to_none=True)
        ed(x_ed).square().mean().backward()

    ed_ms = event_ms(fwd_bwd)
    ed.eval()
    with torch.no_grad():
        ed_eval_ms = event_ms(lambda: ed(x_ed))
    finite = all(bool(torch.isfinite(t).all()) for t in (out_tr, out_ev))
    finite = finite and all(bool(torch.isfinite(p.grad).all())
                            for p in ed.parameters())
    ed64 = ed.double()
    ed_cpu = DenseED(out_channels=2, blocks=P15_ED_BLOCKS).double()
    ed_cpu.load_state_dict({k: v.cpu() for k, v in ed64.state_dict().items()})
    x4 = x_ed[:4].double()
    ed_err = 0.0
    for mode in ("eval", "train"):
        for m in (ed64, ed_cpu):
            getattr(m, mode)()
        with torch.no_grad():
            ed_err = max(ed_err, rel_diff(ed64(x4).cpu(), ed_cpu(x4.cpu())))
    n_par = sum(p.numel() for p in ed.parameters())
    say(f"  DenseED (growth 16, init 48, bn_size 8, blocks "
        f"{P15_ED_BLOCKS}, {n_par} parameters) on {P15_ED_FIELDS} fields of "
        f"64^2 f32: train forward + backward {ed_ms:.2f} ms, eval forward "
        f"{ed_eval_ms:.2f} ms (medians of 3), finite {finite}; card vs CPU "
        f"f64 on 4 fields (eval, train) {ed_err:.3e} (bound "
        f"{P15_ED_RTOL:g})")
    if not (finite and out_ev.shape == (P15_ED_FIELDS, 64, 64, 2)
            and ed_err <= P15_ED_RTOL):
        raise AssertionError("DenseED failed its checks")
    rec["dense_ed"] = dict(train_fwd_bwd_ms=ed_ms, eval_ms=ed_eval_ms,
                           parameters=n_par, card_vs_cpu=ed_err)
    del ed, ed64, ed_cpu, out_tr, out_ev

    # ------------------------------------------------ (f) dataset cache
    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase15_")
    try:
        path = tmp + "/"
        times, loaded = [], []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                t0 = time.perf_counter()
                loaded.append(data_presets.highres32(path=path).setup(
                    device="cuda"))
                times.append(time.perf_counter() - t0)
        (dl0, dlu0), (dl, dlu) = loaded
        hit = (not any(issubclass(c.category, RuntimeWarning)
                       for c in caught)
               and np.array_equal(dl.X, dl0.X)
               and np.array_equal(dlu.X, dlu0.X))
        size_mb = sum(f.stat().st_size for f in Path(tmp).iterdir()) / 1e6

        class highres32_fewer(data_presets.highres32):
            _identifier = "highres32"

            def __init__(self, **kw):
                super().__init__(**kw)
                self._N = P15_STALE_N

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            dl_s, _ = highres32_fewer(path=path).setup(device="cuda")
        stale = any(issubclass(c.category, RuntimeWarning)
                    and "stale" in str(c.message) for c in caught)
        say(f"  dataset cache ({dl.N} + {dlu.N} fields of 32^2, "
            f"{size_mb:.1f} MB on disk): write {times[0]:.2f} s, read "
            f"{times[1]:.2f} s; the second setup a hit with no warning and "
            f"the same fields: {hit}; another _N warned 'stale' and drew "
            f"{dl_s.N}: {stale}")
        if not (hit and stale and dl_s.N == P15_STALE_N
                and dl.X.shape == (1024, 32, 32) and dlu.N == 20480):
            raise AssertionError("the dataset cache failed its checks")
        rec["cache"] = dict(write_s=times[0], read_s=times[1], mb=size_mb)
        del dl, dlu, dl_s, loaded, dl0, dlu0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------- (g) analysis
    res = {}
    n_a = P15_ANALYSIS_FIELDS
    for where, dev in (("card", "cuda"), ("host", "cpu")):
        _, model, _, _, _ = highres32(dtype="float64").setup(
            device=dev, generator=torch.Generator().manual_seed(0))
        data = {"X": torch.as_tensor(X[:n_a], device=dev),
                "Y": Yv64[:n_a].to(dev),
                "F_ROM_BC": F_rom[:n_a].to(dev)}
        with injected_analysis_draws(19):
            analysis, q = Analysis.from_encoder(model, data)
            res[where] = analysis.eval_all(q, None, P15_ANALYSIS_MC)
    err_a = max(abs(res["card"][k] - res["host"][k]) / abs(res["host"][k])
                for k in res["host"])
    say(f"  Analysis.from_encoder + eval_all over {n_a} fields at the "
        f"seed-0 init ({P15_ANALYSIS_MC} samples): {res['card']}; card vs "
        f"CPU f64 {err_a:.3e} (bound {P15_ANALYSIS_RTOL:g})")
    if not (all(np.isfinite(v) for v in res["card"].values())
            and err_a <= P15_ANALYSIS_RTOL):
        raise AssertionError("the analysis failed its checks")
    rec["analysis"] = dict(metrics=res["card"], card_vs_cpu=err_a)
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 15 took {phase_s:.1f} s; card: {card}")
    rec["seconds"] = phase_s
    return derived, rec


def p16_pools():
    """The lifecycle's 24 labeled and 16 unlabeled 32^2 fields (correlation
    length 0.15, keys 2 and 3), drawn on the card."""
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.data import DataLoader

    rf = fem.GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    return (DataLoader.from_sampler(rf, 24, key=2, device="cuda").X,
            DataLoader.from_sampler(rf, 16, key=3, device="cuda").X)


def p16_trainer(dl, dlu, mesh, seed, n_mc=1, data=None, margs=None,
                trainer=None):
    """``tests/test_parallel.py``'s ``_make_trainer`` recipe on the card
    in f64 (24 labeled fields: 16 supervised, 8 validation; 16 unlabeled,
    batch 8) with the changes ``data``, ``margs`` and ``trainer``, set up
    on ``mesh`` (None: unsharded)."""
    from generative_physics_informed_pde_tpu_torch.training import (
        TrainerParameters)

    p = TrainerParameters()
    p.identifier = "highres32"
    p.margs.update(dtype="float64", **(margs or {}))
    p.debug = True
    p.seed = seed
    p.trainer.update(lr_init=1e-2, N_monte_carlo_elbo=n_mc,
                     **(trainer or {}))
    p.scheduler = {"milestones": [50], "factor": 0.5}
    p.data.update(N_u=16, N_s=16, N_u_max=16, N_s_max=16, N_vo_max=0,
                  N_vo=0, N_val=8, armortized_bs=8, vo_spec={})
    p.data.update(data or {})
    return p16_setup(p, dl, dlu, mesh)


def p16_setup(p, dl, dlu, mesh):
    """The trainer of the parameters ``p`` on the loaders ``dl`` (its
    fields in order) and ``dlu`` on the card, set up on ``mesh`` (None:
    unsharded)."""
    import numpy as np
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainerFromPermutation)

    tr = CreateTrainerFromPermutation(
        p, permutation=np.arange(dl.N), permutation_u=np.arange(dlu.N),
        dl=dl, dlu=dlu, device="cuda")
    if mesh is not None:
        tr.setup(scheduler_spec=p.scheduler, mesh=mesh)
    return tr


def p16_uneven(meshes, X, Y, F, Xu):
    """Phase 16d's runs (``P16_UNEVEN``) on the labeled fields ``X`` (labels
    ``Y``, ROM forces ``F``) and the unlabeled ``Xu``; ``meshes`` maps
    "dp" and "mc" to meshes (None: unsharded, one process).  Returns
    {name/key: array} of what phase 16d compares and reports."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import parallel
    from generative_physics_informed_pde_tpu_torch.data import DataLoader

    out = {}
    for name, (kind, recipe) in P16_UNEVEN.items():
        mesh = None if meshes is None else meshes[kind]
        dlu = DataLoader(Xu)
        dlu.lock_physics_assembly()
        tr = p16_trainer(DataLoader(X, Y=Y, F_ROM_BC=F), dlu, mesh,
                         **recipe)
        if mesh is not None and (tr.model.mc_sharding is None) == (
                kind == "mc"):
            raise AssertionError(f"{name}: the Monte-Carlo batch is not "
                                 "split as its mesh says")
        tr.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(P16_UNEVEN_STEPS - 1):
            tr.step()
        torch.cuda.synchronize()
        rate = (P16_UNEVEN_STEPS - 1) / (time.perf_counter() - t0)
        q = tr.model.q_z["supervised"]["mean"].detach()
        if mesh is not None:
            q = parallel.gather_batch(q, mesh)
        params = torch.cat([t.detach().reshape(-1) for n, t in
                            tr.model.named_parameters()
                            if n.split(".", 1)[0] not in ("q_z", "q_X")])
        out.update({f"{name}/q": q.cpu().numpy(),
                    f"{name}/params": params.cpu().numpy(),
                    f"{name}/elbo": tr.elbos().numpy(),
                    f"{name}/generator": tr.generator.get_state().numpy(),
                    f"{name}/steps_per_s": np.asarray(rate)})
        del tr
    return out


def p16_vo_params(arm):
    """``examples/torch_vo_ablation.py``'s ``arm`` (its ``_params``) in
    f64, cut as phase 16e's constants say."""
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_vo_ablation as abl

    if abl.N_VO != P16_VO_N:
        raise AssertionError(f"the ablation's N_vo is {abl.N_VO}")
    n = P16_VO_POOLS
    p = abl._params(P16_VO_STEPS, arm, n["N_s"])
    p.margs["dtype"] = "float64"
    p.seed = 17
    p.scheduler = {"milestones": [50], "factor": 0.5}
    p.data.update(N_u=n["N_u"], N_u_max=n["N_u"], N_val=n["N_val"],
                  armortized_bs=n["armortized_bs"])
    p.trainer.update(N_vo_holdoff=0, N_vo_update_interval=2)
    return p


def p16_vo_fields():
    """Phase 16e's fields: the ablation's 'highres' fields (64^2, FFT,
    correlation length 0.04; labeled key 0, unlabeled key 1) in its
    supervised, VO, validation order, drawn on the card."""
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.fem import (
        GaussianRandomField)

    rf = GaussianRandomField.from_image(64, 64, 0.4, 0.8, 0.04,
                                        method="fft")
    n = P16_VO_POOLS
    return (DataLoader.from_sampler(rf, n["N_s"] + P16_VO_N + n["N_val"],
                                    key=0, device="cuda"),
            DataLoader.from_sampler(rf, n["N_u"], key=1, device="cuda").X)


def p16_vo(mesh, X, X_DG, Y, F, thetas, Xu):
    """Phase 16e's runs (``P16_VO_ARMS``, ``p16_vo_params``) on the
    labeled fields ``X`` (their DG0 fields ``X_DG``, labels ``Y``, ROM
    forces ``F`` and boundary conditions ``thetas``) and the unlabeled
    ``Xu``, on ``mesh`` (None: unsharded, one process).  Each VO refresh
    is timed between synchronisations, its K1 launches counted and its
    peak memory read, whole and above what the process held when the
    refresh began (the refresh's own working set; the process that runs
    the whole script holds the earlier phases' tensors too).  Returns
    {arm/key: array}: the VO moments, q_z, parameters and ELBOs (whole),
    the generators, the VO rows this process holds, and per refresh its
    ms, K1 launches and peak GB (whole, above the start)."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem, parallel
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories import (
        ModelFactory)
    from generative_physics_informed_pde_tpu_torch.ops import apply_stencil

    phys = ModelFactory.FromIdentifier("highres").physics(device="cuda")

    def whole(x):
        x = x.detach()
        return (x if mesh is None else parallel.gather_batch(x, mesh)) \
            .cpu().numpy()

    out = {}
    for arm in P16_VO_ARMS:
        bce = fem.BoundaryConditionEnsemble(phys["fom"].physics_id, thetas)
        bce.register_function_space("fom", phys["fom"].grid)
        bce.register_function_space("rom", phys["rom"].grid)
        dlu = DataLoader(Xu)
        dlu.lock_physics_assembly()
        n0 = apply_stencil.launches
        tr = p16_setup(p16_vo_params(arm), DataLoader(
            X, X_DG=X_DG, Y=Y, BCE=bce, F_ROM_BC=F), dlu, mesh)
        refreshes = []
        refresh = tr.update_virtual_observables

        def timed(step, resample=True):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            k, t0 = apply_stencil.launches, time.perf_counter()
            refresh(step, resample)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            refreshes.append(((time.perf_counter() - t0) * 1e3,
                              apply_stencil.launches - k, peak / 1e9,
                              (peak - held) / 1e9))

        tr.update_virtual_observables = timed
        for _ in range(P16_VO_STEPS):
            tr.step()
        torch.cuda.synchronize()
        ms, launches, peak, rise = (np.asarray(v) for v in zip(*refreshes))
        params = torch.cat([t.detach().reshape(-1) for n, t in
                            tr.model.named_parameters()
                            if n.split(".", 1)[0] not in ("q_z", "q_X")])
        per = tr.VO.num_iterations_per_update * (tr.VO.sampler.N_aux + 1) \
            + 1 if arm == "energy" else sum(
                smp.m + 1 for smp in tr.VO.sampler.samplers
                if smp.__class__.__name__ != "FluxConstrainSampler")
        out.update({f"{arm}/vo_mean": whole(tr.VO.mean),
                    f"{arm}/vo_vars": whole(tr.VO.vars),
                    f"{arm}/q": whole(tr.model.q_z["supervised"]["mean"]),
                    f"{arm}/params": params.cpu().numpy(),
                    f"{arm}/elbo": tr.elbos().numpy(),
                    f"{arm}/generator": tr.generator.get_state().numpy(),
                    f"{arm}/vo_generator":
                        tr.vo_generator.get_state().numpy(),
                    f"{arm}/vo_rows": np.asarray(tr.VO.mean.shape[0]),
                    f"{arm}/refresh_ms": ms,
                    f"{arm}/refresh_launches": launches,
                    f"{arm}/refresh_peak_gb": peak,
                    f"{arm}/refresh_rise_gb": rise,
                    f"{arm}/per_assembly": np.asarray(per),
                    f"{arm}/launches":
                        np.asarray(apply_stencil.launches - n0)})
        del tr
    torch.cuda.empty_cache()
    return out


def p16_vo_derived(path, rec, rows):
    """Phase 16e's K1 launches per shape, from a record of ``p16_vo``
    that holds ``rows`` of the VO rows: the energy arm's applies on its
    rows, the constrain arm's assemblies (one when it is built, one a
    refresh) on all of them; each arm's count checked against them."""
    out = []
    for arm in P16_VO_ARMS:
        per, n = int(rec[f"{arm}/per_assembly"]), len(
            rec[f"{arm}/refresh_launches"])
        count, B = (per * n, rows) if arm == "energy" else (
            per * (n + 1), P16_VO_N)
        if int(rec[f"{arm}/launches"]) != count or any(
                int(k) != per for k in rec[f"{arm}/refresh_launches"]):
            raise AssertionError(
                f"{path} {arm}: K1 launched {int(rec[f'{arm}/launches'])} "
                f"times ({rec[f'{arm}/refresh_launches'].tolist()} a "
                f"refresh), {per} an update or assembly gives {count}")
        out.append((path, "apply_stencil", MG_NODES[0], B, "float64",
                    count))
    return out


def p16_lifecycle(mesh, tmp, X, Xu):
    """``tests/_dcn_child.py``'s lifecycle on the card in f64 on the
    fields ``X`` (labeled) and ``Xu`` (``p16_pools``; every process gets
    the same bits, whose hash seeds the boundary conditions), labels on
    K1 -- with a mesh, only this process's
    supervised rows and the validation rows, the others left NaN --
    then P16_LIFE_STEPS steps (a monitor point at step 5), save, restore,
    2 more steps, finalize.  ``mesh`` None: the same in one process,
    unsharded.  Returns what phase 16b compares and reports."""
    import os

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem, parallel
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.ops import apply_stencil

    dl, dlu = DataLoader(X), DataLoader(Xu)
    dlu.lock_physics_assembly()
    rows = None
    if mesh is not None:
        sup = np.arange(16)[parallel.local_shard_slice(16)]
        rows = np.r_[sup, np.arange(16, dl.N)]
    launches = apply_stencil.launches
    dl.assemble(fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cuda"),
                rows=rows)
    torch.cuda.synchronize()
    launches = apply_stencil.launches - launches
    if rows is not None:
        other = np.setdiff1d(np.arange(dl.N), rows)
        if not (np.isnan(dl.Y[other]).all()
                and np.isfinite(dl.Y[rows]).all()):
            raise AssertionError("the labels were not solved per process")
    tr = p16_trainer(dl, dlu, mesh, seed=11)

    def whole(x):
        x = x.detach()
        return x if mesh is None else parallel.gather_batch(x, mesh)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr.run(P16_LIFE_STEPS, verbose=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    q_saved = whole(tr.model.q_z["supervised"]["mean"])
    t0 = time.perf_counter()
    path = tr.save_checkpoint(os.path.join(tmp, "lifecycle.pt"))
    tr.restore_checkpoint(path)
    ckpt_s = time.perf_counter() - t0
    if not torch.equal(whole(tr.model.q_z["supervised"]["mean"]), q_saved):
        raise AssertionError("the restored q_z block differs")
    t0 = time.perf_counter()
    tr.run(2, verbose=False)
    tr.finalize()
    torch.cuda.synchronize()
    run_s += time.perf_counter() - t0
    return dict(
        q=whole(tr.model.q_z["supervised"]["mean"]).cpu().numpy().tolist(),
        q_rows=int(tr.model.q_z["supervised"]["mean"].shape[0]),
        elbo=list(tr._monitor["elbo"]),
        r2=list(tr._analysis.series["r2_y"].value),
        generator=tr.generator.get_state().tolist(),
        steps_per_s=(P16_LIFE_STEPS + 2) / run_s, checkpoint_s=ckpt_s,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        label_iterations=list(dl.label_iterations),
        label_batch=dl.label_batch, launches=launches,
        launches_after=apply_stencil.launches)


def phase16_child(rank: int, world: int, init: str, out: str) -> int:
    """One of phase 16b's processes (``python3 chip_smoke.py
    --phase16-child RANK WORLD INIT_FILE OUT_DIR``): joins the group on
    the card (two processes on one card: gloo), runs ``p16_lifecycle`` on
    a hybrid ("dcn", "dp") mesh and writes its record to
    ``OUT_DIR/rank{RANK}.json``, then phase 16d's ``p16_uneven`` and
    phase 16e's ``p16_vo`` on ``OUT_DIR/uneven.npz`` and
    ``OUT_DIR/vo.npz``, written to ``OUT_DIR/uneven_rank{RANK}.npz`` and
    ``OUT_DIR/vo_rank{RANK}.npz``."""
    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parallel.initialize(f"file://{init}", world, rank, device="cuda")
    import torch.distributed as dist

    mesh = parallel.make_hybrid_mesh(("dp",), device="cuda")
    with np.load(Path(out) / "pools.npz") as f:
        X, Xu = f["X"], f["Xu"]
    rec = p16_lifecycle(mesh, out, X, Xu)
    rec.update(backend=dist.get_backend(), mesh=[list(mesh.mesh_dim_names),
                                                 list(mesh.shape)])
    with open(Path(out) / f"rank{rank}.json", "w") as fh:
        json.dump(rec, fh)
    # (d): the batches that do not divide by the shard count
    meshes = {"dp": parallel.make_mesh(device="cuda"),
              "mc": parallel.make_mesh(2, ("dp", "mc"), (1, 2),
                                       device="cuda")}
    with np.load(Path(out) / "uneven.npz") as f:
        uneven = p16_uneven(meshes, f["X"], f["Y"], f["F"], f["Xu"])
    np.savez(Path(out) / f"uneven_rank{rank}.npz", **uneven)
    # (e): the virtual observables split over the processes
    with np.load(Path(out) / "vo.npz") as f:
        vo = p16_vo(meshes["dp"], **{k: f[k] for k in f.files})
    np.savez(Path(out) / f"vo_rank{rank}.npz", **vo)
    dist.destroy_process_group()
    print(f"[phase 16b process {rank}] ok", flush=True)
    return 0


def phase16_sharded(card, dl, dlu, start_path, end_path, add_path):
    """Phase 16: sharded training and the VO ablation on the card.  (a)
    The highres32 recipe (phase 4b's pools) P16_STEPS steps through
    ``setup(mesh=make_mesh(1))`` against ``setup()``, deterministic cuDNN:
    bit-equal.  (b) Two processes on the one card, started from this
    script, run ``tests/_dcn_child.py``'s lifecycle in f64 on a hybrid
    mesh (``p16_lifecycle``), each labeling its own rows on K1; their
    q_z block, monitor ELBO and R^2 held to the same lifecycle in one
    process on the card to P16_RTOL; a child that fails or outlives
    P16_CHILD_TIMEOUT fails the phase.  (d) The same two processes then
    train the batches that do not divide by the shard count
    (``P16_UNEVEN``, ``p16_uneven``) on labels solved once here on K1,
    each held to one process on the card to P16_RTOL.  (e) Then they
    train the VO ablation's energy and constrain arms at their published
    widths in f64 (``P16_VO_ARMS``, ``p16_vo_params``, ``p16_vo``) on
    64^2 fields labeled once here on K1, each process refreshing its rows
    of the VO fields, each held to one process on the card to P16_RTOL,
    the VO rows, K1 launches, refresh ms and peak GB of every process
    printed.  (c) The three arms of
    ``examples/torch_vo_ablation.py`` through its ``main`` and
    ``run_arm`` at the published 64^2 widths and pools, cut (see the
    constants), results written to a temporary directory.  Returns
    (derived launches [(path, kernel, nodes, B, dtype, launches)],
    records)."""
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem, parallel
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler)
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories import (
        ModelFactory)
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer, Trainer)

    t_phase = time.perf_counter()
    say("phase 16: sharded training (one-device mesh, two processes on "
        f"the card) and the VO ablation; card: {card}")
    derived, rec = [], {}

    # ------------------------------------------- (a) a one-device mesh
    start_path()
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        states, rates = {}, {}
        for name, mesh in (("setup()", None),
                           ("setup(mesh=make_mesh(1))",
                            parallel.make_mesh(1, device="cuda"))):
            p = recipe_params()
            tr = CreateTrainer(p, *labeled_copies(dl, dlu), device="cuda")
            if mesh is not None:
                tr.setup(scheduler_spec=p.scheduler or None, mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(P16_STEPS):
                tr.step()
            torch.cuda.synchronize()
            rates[name] = P16_STEPS / (time.perf_counter() - t0)
            states[name] = [t.detach().clone() for t in (
                *tr.model.parameters(), *tr.model.buffers(),
                *tr._PE.q.values(), tr.elbos(),
                tr.generator.get_state())]
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    end_path("16a one-device mesh")
    a, b = states.values()
    equal = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    say(f"  (a) highres32 recipe, {P16_STEPS} steps f32: one-device mesh "
        f"bit-equal to setup() over {len(a)} tensors (parameters, "
        f"statistics, posteriors, ELBOs, generator): {equal}; steps/s "
        f"{ {k: round(v, 3) for k, v in rates.items()} }")
    if not equal:
        raise AssertionError("the one-device mesh differs from setup()")
    rec["one_device"] = dict(steps_per_s=rates, tensors=len(a))

    # ------------------------------- (b) two processes on the one card
    tmp = tempfile.mkdtemp(prefix="chip_smoke_p16_")
    try:
        env = dict(os.environ)
        for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                  "LOCAL_WORLD_SIZE", "LOCAL_RANK"):
            env.pop(k, None)
        env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        init = os.path.join(tmp, "init")
        X16, Xu16 = p16_pools()
        np.savez(os.path.join(tmp, "pools.npz"), X=X16, Xu=Xu16)
        # (d)'s labels, solved once here on K1 and handed to every run
        start_path()
        dl_u = DataLoader(X16)
        dl_u.assemble(fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cuda"))
        end_path("16d uneven labels")
        derived += [("16d uneven labels", "apply_stencil", 33,
                     dl_u.label_batch, "float64", k + 1)
                    for k in dl_u.label_iterations]
        uneven_data = dict(X=X16, Y=dl_u.Y, F=dl_u.F_ROM_BC, Xu=Xu16)
        np.savez(os.path.join(tmp, "uneven.npz"), **uneven_data)
        # (e)'s fields, labeled once here on K1 under the V-cycle
        dl_vo, Xu_vo = p16_vo_fields()
        phys_vo = ModelFactory.FromIdentifier("highres").physics(
            device="cuda")
        start_path()
        dl_vo.assemble(phys_vo)
        end_path("16e labels")
        mg = phys_vo["fom"]._batched_solver.mg
        derived += [r for k in dl_vo.label_iterations for r in mg_rows(
            "16e labels", mg, MG_NODES, dl_vo.label_batch, "float64", k)]
        vo_data = dict(X=dl_vo.X, X_DG=dl_vo.X_DG, Y=dl_vo.Y,
                       F=dl_vo.F_ROM_BC, thetas=dl_vo.BCE.thetas, Xu=Xu_vo)
        np.savez(os.path.join(tmp, "vo.npz"), **vo_data)
        del dl_vo, phys_vo
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--phase16-child", str(r), "2", init, tmp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        outs, late = [], False
        for pr in procs:
            try:
                o, _ = pr.communicate(
                    timeout=max(1.0, P16_CHILD_TIMEOUT
                                - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                late = True
                for q in procs:
                    q.kill()
                o, _ = pr.communicate()
            outs.append(o)
        children_s = time.perf_counter() - t0
        for r, pr in enumerate(procs):
            if late or pr.returncode != 0:
                raise AssertionError(
                    f"phase 16b process {r} {'timed out' if late else 'failed'}"
                    f" (rc {pr.returncode}):\n{outs[r][-3000:]}")
        kids = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                for r in range(2)]
        kids_uneven = [dict(np.load(Path(tmp, f"uneven_rank{r}.npz")))
                       for r in range(2)]
        kids_vo = [dict(np.load(Path(tmp, f"vo_rank{r}.npz")))
                   for r in range(2)]
        start_path()
        one = p16_lifecycle(None, tmp, X16, Xu16)
        end_path("16b one process")
        one_uneven = p16_uneven(None, **uneven_data)
        start_path()
        one_vo = p16_vo(None, **vo_data)
        end_path("16e one process")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for path, r in [("16b one process", one)] + [
            (f"16b process {i}", k) for i, k in enumerate(kids)]:
        derived += [(path, "apply_stencil", 33, r["label_batch"], "float64",
                     k + 1) for k in r["label_iterations"]]
    for i, k in enumerate(kids):
        if k["launches"] != k["launches_after"] or k["launches"] != sum(
                n + 1 for n in k["label_iterations"]):
            raise AssertionError(f"process {i} launched K1 "
                                 f"{k['launches_after']} times")
        add_path(f"16b process {i}", {"apply_stencil": k["launches"]})
    errs = {}
    for key in ("q", "elbo", "r2"):
        ref = np.asarray(one[key])
        scale = max(np.abs(ref).max(), 1e-300)
        errs[key] = max(float(np.abs(np.asarray(k[key]) - ref).max() / scale)
                        for k in kids)
    same_gen = all(k["generator"] == one["generator"] for k in kids)
    say(f"  (b) two processes on the card ({kids[0]['backend']}, mesh "
        f"{kids[0]['mesh']}, {kids[0]['q_rows']} of 16 q_z rows each), "
        f"{children_s:.1f} s with start-up: labels per process "
        f"{[k['label_iterations'] for k in kids]} PCG iterations "
        f"({[k['launches'] for k in kids]} K1 launches, the one process "
        f"{one['launches']}); steps/s (with the monitor point, checkpoint "
        f"and finalize) processes {[round(k['steps_per_s'], 3) for k in kids]}"
        f", one process {one['steps_per_s']:.3f}; peak memory GB "
        f"{[round(k['peak_gb'], 4) for k in kids]} vs "
        f"{one['peak_gb']:.4f}; checkpoint save + restore "
        f"{[round(k['checkpoint_s'], 3) for k in kids]} s")
    say(f"      against one process: max rel q_z {errs['q']:.3e}, monitor "
        f"ELBO {errs['elbo']:.3e}, R^2 {errs['r2']:.3e} (bound "
        f"{P16_RTOL:g}); generators equal: {same_gen}")
    if not (max(errs.values()) <= P16_RTOL and same_gen
            and all(k["q_rows"] == 8 for k in kids)
            and len(one["elbo"]) == 1 and len(one["r2"]) == 3):
        raise AssertionError("two processes on the card differ from one")
    rec["two_processes"] = dict(
        errors=errs, steps_per_s=[k["steps_per_s"] for k in kids],
        one_process_steps_per_s=one["steps_per_s"],
        peak_gb=[k["peak_gb"] for k in kids], one_peak_gb=one["peak_gb"],
        launches=[k["launches"] for k in kids], seconds=children_s)

    # --------------------------- (d) batches that do not divide, 2 processes
    rec["uneven"], worst = {}, 0.0
    for name, (kind, _) in P16_UNEVEN.items():
        e = {}
        for key in ("q", "params", "elbo"):
            ref = one_uneven[f"{name}/{key}"]
            scale = max(np.abs(ref).max(), 1e-300)
            e[key] = max(float(np.abs(k[f"{name}/{key}"] - ref).max()
                               / scale) for k in kids_uneven)
        gen = all(np.array_equal(k[f"{name}/generator"],
                                 one_uneven[f"{name}/generator"])
                  for k in kids_uneven)
        rates = [float(k[f"{name}/steps_per_s"]) for k in kids_uneven]
        one_rate = float(one_uneven[f"{name}/steps_per_s"])
        say(f"  (d) {name} on the {kind} mesh, f64, {P16_UNEVEN_STEPS} "
            f"steps: against one process max rel q_z {e['q']:.3e}, "
            f"parameters {e['params']:.3e}, ELBOs {e['elbo']:.3e} (bound "
            f"{P16_RTOL:g}); generators equal: {gen}; steps/s over the "
            f"last {P16_UNEVEN_STEPS - 1} processes "
            f"{[round(r, 3) for r in rates]}, one process {one_rate:.3f}")
        if not (max(e.values()) <= P16_RTOL and gen):
            raise AssertionError(f"the uneven run {name} on two processes "
                                 "differs from one")
        worst = max(worst, *e.values())
        rec["uneven"][name] = dict(errors=e, steps_per_s=rates,
                                   one_process_steps_per_s=one_rate)
    say(f"  (d) the uneven runs' largest difference {worst:.3e}")

    # ------------------ (e) the virtual observables split, 2 processes
    derived += p16_vo_derived("16e one process", one_vo, P16_VO_N)
    for i, k in enumerate(kids_vo):
        path = f"16e process {i}"
        derived += p16_vo_derived(path, k, P16_VO_N // 2)
        add_path(path, {"apply_stencil": sum(
            int(k[f"{arm}/launches"]) for arm in P16_VO_ARMS)})
    rec["vo"] = {}
    for arm in P16_VO_ARMS:
        e = {}
        for key in ("vo_mean", "vo_vars", "q", "params", "elbo"):
            ref = one_vo[f"{arm}/{key}"]
            scale = max(np.abs(ref).max(), 1e-300)
            e[key] = max(float(np.abs(k[f"{arm}/{key}"] - ref).max()
                               / scale) for k in kids_vo)
        gen = all(np.array_equal(k[f"{arm}/{g}"], one_vo[f"{arm}/{g}"])
                  for k in kids_vo for g in ("generator", "vo_generator"))
        rows = [int(k[f"{arm}/vo_rows"]) for k in kids_vo]
        keys = (("ms", "refresh_ms"), ("launches", "refresh_launches"),
                ("peak_gb", "refresh_peak_gb"),
                ("rise_gb", "refresh_rise_gb"))
        per = {name: [k[f"{arm}/{key}"].tolist() for k in kids_vo]
               for name, key in keys}
        one_per = {name: one_vo[f"{arm}/{key}"].tolist()
                   for name, key in keys}
        batch = (P16_VO_N // 2, P16_VO_N) if arm == "energy" else (
            P16_VO_N, P16_VO_N)
        say(f"  (e) {arm} VO, f64, {P16_VO_STEPS} steps, "
            f"{len(one_per['ms'])} refreshes: VO rows per process {rows} "
            f"of {P16_VO_N} (one process {int(one_vo[f'{arm}/vo_rows'])});"
            f" K1 launches per refresh per process {per['launches']} at B "
            f"= {batch[0]} (one process {one_per['launches']} at B = "
            f"{batch[1]})")
        say(f"      refresh ms per process "
            f"{[[round(x, 2) for x in v] for v in per['ms']]} (one process "
            f"{[round(x, 2) for x in one_per['ms']]}); peak GB in a refresh "
            f"per process {[[round(x, 4) for x in v] for v in per['peak_gb']]}"
            f" (one process {[round(x, 4) for x in one_per['peak_gb']]}), "
            "of it above what the process held as the refresh began "
            f"{[[round(x, 5) for x in v] for v in per['rise_gb']]} (one "
            f"process {[round(x, 5) for x in one_per['rise_gb']]})")
        say(f"      against one process max rel VO mean {e['vo_mean']:.3e}, "
            f"vars {e['vo_vars']:.3e}, q_z {e['q']:.3e}, parameters "
            f"{e['params']:.3e}, ELBOs {e['elbo']:.3e} (bound "
            f"{P16_RTOL:g}); generators equal: {gen}")
        if not (max(e.values()) <= P16_RTOL and gen
                and rows == [P16_VO_N // 2] * 2):
            raise AssertionError(f"the {arm} VO on two processes differs "
                                 "from one")
        rec["vo"][arm] = dict(errors=e, rows=rows, batch=batch,
                              refresh=per, one_process=one_per)

    # -------------------------------------------- (c) the VO ablation
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_vo_ablation as abl

    params, create, run_arm = (abl._params, abl.CreateTrainerFromPermutation,
                               abl.run_arm)
    refresh = Trainer.update_virtual_observables
    made, refreshes, arms = [], [], {}

    def cut_params(iterations, arm, n_s, vo_cadence=None, temper=1.0):
        p = params(iterations, arm, n_s, vo_cadence, temper)
        if arm == "energy":
            p.trainer["N_vo_holdoff"] = P16_ABL_HOLDOFF
        return p

    def capture(*a, **k):
        made.append(create(*a, **k))
        return made[-1]

    def counted_refresh(self, step, resample=True):
        refreshes.append(step)
        return refresh(self, step, resample)

    def counted_arm(arm, *a, **k):
        made.clear()
        refreshes.clear()
        start_path()
        out = run_arm(arm, *a, **k)
        counts = end_path(f"16c {arm}")
        arms[arm] = dict(out=out, counts=counts, tr=made[-1],
                         refreshes=list(refreshes))
        return out

    tmp = tempfile.mkdtemp(prefix="chip_smoke_p16_")
    abl._params, abl.CreateTrainerFromPermutation = cut_params, capture
    abl.run_arm = counted_arm
    Trainer.update_virtual_observables = counted_refresh
    try:
        rows = abl.main([str(P16_ABL_STEPS), "--cadence",
                         str(P16_ABL_HOLDOFF)], device="cuda",
                        path=os.path.join(tmp, "torch_vo_ablation.json"))
        written = json.loads(Path(tmp, "torch_vo_ablation.json").read_text())
    finally:
        abl._params, abl.CreateTrainerFromPermutation = params, create
        abl.run_arm = run_arm
        Trainer.update_virtual_observables = refresh
        shutil.rmtree(tmp, ignore_errors=True)
    if written != rows or sorted(arms) != ["constrain", "energy", "labels"]:
        raise AssertionError("the ablation did not run its three arms")
    rec["ablation"] = {}
    for arm, r in arms.items():
        tr, out = r["tr"], r["out"]
        mg = tr.physics["fom"]._batched_solver.mg
        path = f"16c {arm}"
        label_rows = [r for k in tr.dl.label_iterations for r in mg_rows(
            path, mg, MG_NODES, tr.dl.label_batch, "float64", k)]
        vo = 0
        if arm == "constrain":
            per = sum(smp.m + 1 for smp in tr.VO.sampler.samplers
                      if not isinstance(smp, FluxConstrainSampler))
            vo = per * (1 + len(r["refreshes"]))
        elif arm == "energy":
            spec = tr.VO.sampler
            per = tr.VO.num_iterations_per_update * (spec.N_aux + 1) + 1
            vo = per * len(r["refreshes"])
        if vo:
            label_rows.append((path, "apply_stencil", MG_NODES[0], C2_VO,
                               "float32", vo))
        derived += label_rows
        elbos = tr.elbos()
        finite = bool(torch.isfinite(elbos).all()) and all(
            np.isfinite(out[k]) for k in ("relerr_y", "r2_y", "logscore_y"))
        say(f"  (c) {out['arm']}: rel-L2 {out['relerr_y']:.4f}, R^2 "
            f"{out['r2_y']:.4f}, logscore {out['logscore_y']:.4f}, "
            f"{out['steps_per_sec']:.3f} steps/s ({P16_ABL_STEPS} steps, the "
            f"final refinement and analysis included); refreshes at "
            f"{r['refreshes']}; K1 launches {r['counts']['apply_stencil']} "
            f"(labels {tr.dl.label_iterations} PCG iterations, VO {vo}); "
            f"every ELBO finite: {finite}")
        if not finite or elbos.shape != (P16_ABL_STEPS,):
            raise AssertionError(f"the {arm} arm is not finite")
        if arm != "labels" and r["refreshes"] != P16_REFRESHES:
            raise AssertionError(f"the {arm} arm refreshed at "
                                 f"{r['refreshes']}")
        rec["ablation"][arm] = dict(
            {k: out[k] for k in ("arm", "relerr_y", "r2_y", "logscore_y",
                                 "steps_per_sec")},
            refreshes=r["refreshes"], launches=r["counts"]["apply_stencil"])
    del arms, made
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase
    say(f"  phase 16 took {phase_s:.1f} s; card: {card}")
    rec["seconds"] = phase_s
    return derived, rec


def phase17_options(card, resumed, dl, dlu, start_path, end_path):
    """Phase 17: the options the port took over last.  (a) The V-cycle's
    steps in bf16 against their plain versions, bit for bit, on every
    level of config 5's pool, (65..5)^2 x 16,384; (b) config 5's 16,384
    64^2 f32
    fields (the warm sweep's, seed 1) solved under the bf16 V-cycle
    (``precond_dtype="bfloat16"``, the main path: its launches are
    counted) and under the f32 V-cycle, every system's true residual, the
    iterations and the warm times of both; (c) the JAX package's
    high-contrast case at 128^2 under the bf16 V-cycle; (d) the resumed
    config 3 trainer of phase 10 exported for ``("cuda", "cpu")``, loaded
    on both and checked at every bucket; (e) highres32 steps under
    ``Trainer.run(profile_dir=)`` and the trace's kernel events; (f) three
    f64 steps of a trainer whose labels were solved with given BC
    encodings (``CreateTrainerFromPermutation(BCE_encoding=)``).  Returns
    (derived launches, what the records read)."""
    import glob
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch
    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.fem.batched_solver \
        import make_batched_fom_solver
    from generative_physics_informed_pde_tpu_torch.ops import (
        apply_stencil_reference)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer, CreateTrainerFromPermutation)

    t_phase = time.perf_counter()
    out, derived = {}, []
    say(f"phase 17: the bf16 V-cycle in its step kernels, the two-platform "
        f"bundle, the profiled run, BC encodings; card: {card}")
    # ------------------------ (a) + (b) config 5's pool, bf16 vs f32 V-cycle
    us = torch_runner().torch_uncertainty_study
    phys = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(
        C5_N, C5_N), device="cuda")
    fields = us.sample_fields(us.CORRLENGTHS, C5_B, n=C5_N, seed=1,
                              device="cuda")
    bc = us.centre_bc_values(phys, C5_SYSTEMS)
    alphas = torch.exp(phys.pixels.image_to_function(fields))
    del fields
    solvers = {d: make_batched_fom_solver(phys.op, phys.profile,
                                          precond="mg", precond_dtype=d)
               for d in ("bfloat16", "float32")}
    mg = solvers["bfloat16"].mg
    if mg.dtype != "bfloat16" or mg.num_levels != len(MG_NODES):
        raise AssertionError(f"the bf16 solver's V-cycle is {mg}")
    shapes = vcycle_levels_check(mg, alphas, torch.Generator().manual_seed(
        17))
    torch.cuda.empty_cache()
    say(f"  (a) the V-cycle's steps in bf16 bit-equal to their plain "
        f"versions on the levels {shapes}")
    path = "17 bf16 V-cycle"
    start_path()
    Y = {"bfloat16": solvers["bfloat16"](alphas, bc)}
    counts = end_path(path)
    k = solvers["bfloat16"].iterations
    rows = mg_rows(path, mg, MG_NODES, C5_SYSTEMS, "float32", k)
    check_launches(f"the bf16 V-cycle solve of {k} iterations", counts, rows)
    derived += rows
    Y["float32"] = solvers["float32"](alphas, bc)
    iters = {d: s_.iterations for d, s_ in solvers.items()}
    res = {}
    for d, y in Y.items():
        res[d] = torch.cat([true_residual(
            phys, y[i:i + C5_SLICE], alphas[i:i + C5_SLICE],
            bc[i:i + C5_SLICE], apply_stencil_reference)
            for i in range(0, C5_SYSTEMS, C5_SLICE)]).max().item()
    diff = ((Y["bfloat16"] - Y["float32"]).norm(dim=1)
            / Y["float32"].norm(dim=1)).max().item()
    ms = {d: event_ms(lambda s_=s_: s_(alphas, bc))
          for d, s_ in solvers.items()}
    say(f"  (b) {C5_SYSTEMS} fields of {C5_N}^2 f32, precond='mg': bf16 "
        f"V-cycle {iters['bfloat16']} PCG iterations, {ms['bfloat16']:.2f} "
        f"ms warm, true residual max {res['bfloat16']:.3e}; f32 V-cycle "
        f"{iters['float32']} iterations, {ms['float32']:.2f} ms, "
        f"{res['float32']:.3e} (bound {F32_FLOOR:g}); bf16 vs f32 labels "
        f"rel-L2 max {diff:.3e}; bf16 launches {counts} (medians of 3, "
        f"CUDA events); card: {card}")
    if not max(res.values()) <= F32_FLOOR or not diff <= F32_FLOOR:
        raise AssertionError("a config 5 system's residual under the bf16 "
                             "or f32 V-cycle exceeds the f32 floor")
    out["bf16_vcycle"] = dict(
        iterations=iters, warm_ms=ms, max_true_residual=res,
        bf16_vs_f32_rel=diff, launches=counts)
    del alphas, bc, Y, solvers

    # --------------------------------- (c) the JAX test's high-contrast case
    hc = fem.LinearEllipticPhysics("fom", "ND", fem.StructuredTriGrid(
        P17_HC_N, P17_HC_N), device="cuda")
    rng = np.random.default_rng(3)
    a_hc = torch.as_tensor(np.exp(rng.normal(
        0, P17_HC_SIGMA, (P17_HC_B, hc.grid.n_cells))),
        dtype=torch.float32, device="cuda")
    v_hc = torch.as_tensor(hc.profile.constrained_values(
        np.tile([[0.0, 0.0, 1.0, 1.0]], (P17_HC_B, 1))),
        dtype=torch.float32, device="cuda")
    s_hc = make_batched_fom_solver(hc.op, hc.profile, precond="mg",
                                   precond_dtype="bfloat16", tol=P17_HC_TOL)
    y_hc = s_hc(a_hc, v_hc)
    r_hc = true_residual(hc, y_hc, a_hc, v_hc, apply_stencil_reference)
    say(f"  (c) {P17_HC_N}^2, B={P17_HC_B}, sigma {P17_HC_SIGMA}, bf16 "
        f"V-cycle ({s_hc.mg.num_levels} levels): {s_hc.iterations} PCG "
        f"iterations, true residuals {r_hc.tolist()} (bound "
        f"{10 * P17_HC_TOL:g})")
    if not bool(torch.isfinite(y_hc).all()) \
            or not bool((r_hc < 10 * P17_HC_TOL).all()):
        raise AssertionError("the high-contrast bf16 V-cycle solve is above "
                             "10 x its tolerance")
    out["high_contrast"] = dict(iterations=s_hc.iterations,
                                true_residual=r_hc.tolist())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_phase17_")
    try:
        # -------------------------- (d) the bundle for ("cuda", "cpu")
        bpath = os.path.join(tmp, "surrogate.zip")
        t0 = time.perf_counter()
        bundle = resumed.export_surrogate(bpath, platforms=("cuda", "cpu"))
        export_s = time.perf_counter() - t0
        loaded = {d: SurrogateBundle.load(bpath, device=d)
                  for d in ("cuda", "cpu")}
        if not all(b.platforms == ("cuda", "cpu") for b in loaded.values()):
            raise AssertionError("the bundle's platforms are "
                                 f"{loaded['cpu'].platforms}")
        pool = resumed.dl
        rows = np.arange(max(bundle.buckets)) % pool.N
        xs = torch.as_tensor(pool.X[rows], dtype=torch.float32)
        fs = torch.as_tensor(pool.F_ROM_BC[rows], dtype=torch.float32)
        cpu_err = {}
        for b in bundle.buckets:
            want = bundle.predict(xs[:b].cuda(), fs[:b].cuda())
            got = loaded["cuda"].predict(xs[:b].cuda(), fs[:b].cuda())
            on_cpu = loaded["cpu"].predict(xs[:b], fs[:b])
            if not torch.equal(bits(got), bits(want)) \
                    or on_cpu.device.type != "cpu" \
                    or not bool(torch.isfinite(on_cpu).all()):
                raise AssertionError(f"bucket {b}: the card's program is not "
                                     "bit-equal to the module, or the CPU's "
                                     "is not finite on the CPU")
            cpu_err[b] = ((on_cpu - want.cpu()).abs().max()
                          / want.abs().max()).item()
        say(f"  (d) the resumed config 3 surrogate for ('cuda', 'cpu'): "
            f"{os.path.getsize(bpath) / 1e6:.2f} MB, export {export_s:.2f} "
            f"s; card program bit-equal to the module at buckets "
            f"{list(bundle.buckets)}; CPU program max rel "
            f"{ {b: f'{e:.2e}' for b, e in cpu_err.items()} } (bound "
            f"{P17_CPU_RTOL:g})")
        if not max(cpu_err.values()) <= P17_CPU_RTOL:
            raise AssertionError("the bundle's CPU program is far from the "
                                 "card's module")
        out["bundle"] = dict(export_s=export_s, cpu_rel=cpu_err,
                             mb=os.path.getsize(bpath) / 1e6)
        del bundle, loaded

        # ------------------------------------------- (e) a profiled run
        p = recipe_params()
        p.trainer.update(N_monitor_interval=0, N_PE_updates_final=0)
        tr = CreateTrainer(p, *labeled_copies(dl, dlu), device="cuda")
        tr.step()
        pdir = os.path.join(tmp, "profile")
        t0 = time.perf_counter()
        tr.run(P17_PROFILED_STEPS, verbose=False, profile_dir=pdir)
        prof_s = time.perf_counter() - t0
        traces = glob.glob(os.path.join(pdir, "*.pt.trace.json"))
        if len(traces) != 1:
            raise AssertionError(f"the profiled run wrote {traces}")
        with open(traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        n_kernels = sum(1 for e in events if e.get("cat") == "kernel")
        say(f"  (e) {P17_PROFILED_STEPS} highres32 steps under "
            f"run(profile_dir=): {prof_s:.2f} s with the trace written, "
            f"{os.path.getsize(traces[0]) / 1e6:.1f} MB, {len(events)} "
            f"events, {n_kernels} CUDA kernel events")
        if n_kernels == 0 or torch.autograd._profiler_enabled():
            raise AssertionError("the trace holds no CUDA kernel, or the "
                                 "profiler was left running")
        out["profile"] = dict(seconds=prof_s, events=len(events),
                              kernel_events=n_kernels)
        del tr
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------- (f) given BC encodings
    n_lab, n_u = P17_BCE_LABELED, P17_BCE_UNLABELED
    enc = fem.BoundaryConditionEnsemble.from_factory(
        "NDP", n_lab, np.random.default_rng(17)).encode()
    p64 = recipe_params("float64")
    p64.trainer.update(N_monitor_interval=0, N_PE_updates_final=0)
    p64.data.update(N_s=n_lab // 2, N_s_max=n_lab // 2, N_val=n_lab // 2,
                    N_vo=0, N_vo_max=0, N_u=n_u, N_u_max=n_u)
    path = "17 BCE_encoding train"
    start_path()
    tr = CreateTrainerFromPermutation(
        p64, np.arange(n_lab), np.arange(n_u), dl=DataLoader(dl.X[:n_lab]),
        dlu=DataLoader(dlu.X[:n_u]), BCE_encoding=enc, device="cuda")
    for _ in range(P17_BCE_STEPS):
        tr.step()
    counts = end_path(path)
    for k_ in tr.dl.label_iterations:
        derived.append((path, "apply_stencil", 33, n_lab, "float64",
                        k_ + 1))
    fom = tr.physics["fom"]
    a64 = torch.exp(fom.pixels.image_to_function(torch.as_tensor(
        dl.X[:n_lab], dtype=torch.float64, device="cuda")))
    v64 = torch.as_tensor(tr.dl.BCE.constrained_values("fom"),
                          device="cuda")
    r64 = true_residual(fom, torch.as_tensor(tr.dl.Y, device="cuda"), a64,
                        v64, apply_stencil_reference).max().item()
    elbos = tr.elbos()
    say(f"  (f) {n_lab} labels solved with given encodings (iterations "
        f"{tr.dl.label_iterations}, launches {counts}), true residual max "
        f"{r64:.3e} (tolerance {TOL_F64:g}); {P17_BCE_STEPS} f64 ELBOs "
        f"{elbos.tolist()}")
    if not np.array_equal(tr.dl.BCE.encode(), enc) or not r64 <= TOL_F64 \
            or not bool(torch.isfinite(elbos).all()) \
            or elbos.shape != (P17_BCE_STEPS,):
        raise AssertionError("the BCE-encoded trainer's labels or ELBOs are "
                             "off")
    out["bce_encoding"] = dict(label_iterations=list(tr.dl.label_iterations),
                               true_residual=r64, elbos=elbos.tolist())
    del tr
    out["phase_s"] = time.perf_counter() - t_phase
    say(f"  phase 17 took {out['phase_s']:.1f} s; card: {card}")
    return derived, out


def vcycle_shape_rows(shape_launches, mg, gen, flush):
    """Phase 8's rows of the V-cycle's steps: at every shape of
    ``VCYCLE_SHAPES``, random inputs (``vcycle_inputs``, ``mg``'s sweeps)
    held bit for bit against the plain version, the flushed / clean / warm
    times, the byte bound and ``shape_launches``' launches there.  Returns
    {step: (rows, the times at config 5's levels in f32 with the plain
    version's)}; ``gen`` a CUDA generator, ``flush`` a zeroed tensor
    larger than the L2."""
    import torch
    from generative_physics_informed_pde_tpu_torch.ops import vcycle

    out = {}
    for kname, shapes in VCYCLE_SHAPES.items():
        kernel = getattr(vcycle, kname)
        plain = getattr(vcycle, f"{kname}_reference")
        rows, timing = [], None
        for nodes, B, dname in shapes:
            inputs = vcycle_inputs(nodes, B, dname, gen)
            args = vcycle_args(kname, mg, *inputs)
            got, ref = kernel(*args), plain(*args)
            if got.dtype != ref.dtype or got.shape != ref.shape \
                    or not torch.equal(bits(got), bits(ref)):
                raise AssertionError(f"{kname} is not bit-equal to its plain "
                                     f"version at {(nodes, nodes, B)} "
                                     f"{dname}")
            moved, bound, by = vcycle_cost(kname, nodes, B,
                                           got.element_size(), mg.nu_coarse)
            # warm first: the 256 MB flushes slow the calls that follow
            t_w = cuda_time_ms(lambda: kernel(*args), 200)
            t_c = cuda_time_ms(lambda: kernel(*args), 100, flush.sum)
            t_f = cuda_time_ms(lambda: kernel(*args), 100, flush)
            launches = shape_launches[(kname, nodes, B, dname)]
            rows.append(dict(
                shape=[nodes, nodes, B], dtype=dname, launches=launches,
                bytes=moved, bound_ms=bound, bound_by=by, ms=t_f,
                ms_l2_clean=t_c, ms_l2_warm=t_w,
                share_of_bound=bound / t_c,
                excess_ms=launches * (t_c - bound)))
            if (B, dname) == (C5_SYSTEMS, "float32") and nodes == (
                    MG_NODES[-1] if kname == "vcycle_coarse"
                    else MG_NODES[0]):
                timing = dict(
                    ms=t_f, ms_l2_clean=t_c, ms_l2_warm=t_w,
                    plain_ms_l2_warm=cuda_time_ms(lambda: plain(*args), 20),
                    plain_ms=cuda_time_ms(lambda: plain(*args), 10, flush),
                    bound_ms=bound, bound_by=by, bytes=moved,
                    shape=[nodes, nodes, B], dtype=dname)
            del inputs, args, got, ref
        out[kname] = (rows, timing)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr, flush=True)
        return 2
    import numpy as np

    from generative_physics_informed_pde_tpu_torch import fem
    from generative_physics_informed_pde_tpu_torch.constraints import (
        FluxConstrainSampler, build_virtual_observables_ensemble,
        vo_spec_preset)
    from generative_physics_informed_pde_tpu_torch.factories import highres32
    from generative_physics_informed_pde_tpu_torch.data import DataLoader
    from generative_physics_informed_pde_tpu_torch.factories.data import (
        DataFactory)
    from generative_physics_informed_pde_tpu_torch.fem.batched_solver \
        import make_batched_fom_solver
    from generative_physics_informed_pde_tpu_torch.factories import highres
    from generative_physics_informed_pde_tpu_torch import ops
    from generative_physics_informed_pde_tpu_torch.ops import (
        _build, apply_stencil, apply_stencil_reference, apply_stencil_sym,
        apply_stencil_sym_blocked, apply_stencil_sym_blocked_reference,
        apply_stencil_sym_reference)
    from generative_physics_informed_pde_tpu_torch.serving import (
        SurrogateBundle)
    from generative_physics_informed_pde_tpu_torch.training import (
        CreateTrainer)

    kernels_ = tuple(getattr(ops, name) for name in STENCILS + FUSED)
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

    def add_path(name, counts):
        """Counts of a main path that another process ran (its wrappers
        counted its launches)."""
        path_launches[name] = {k.__name__: counts.get(k.__name__, 0)
                               for k in kernels_}
        for k in kernels_:
            main_launches[k.__name__] += path_launches[name][k.__name__]

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
    with plain_applies() as plain:
        Y_plain = fom.solve_batched(alphas, vals)
    if plain.launched:
        raise AssertionError(f"the plain-path solve launched {plain.launched}")
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
        check_launches(f"VJP sym={sym}", counts,
                       [(None, used, 33, N, "float64", expect)])
        with plain_applies() as plain:
            _, pa, pb, _ = solve_grads(fom, alphas64, vals64, w, sym)
        if plain.launched:
            raise AssertionError(f"the plain-path VJP sym={sym} launched "
                                 f"{plain.launched}")
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

    p_vo = recipe_params(vo=True)
    # cut from the example's 250: three refreshes (steps 50, 100, 150)
    # fall inside the 200 steps
    p_vo.trainer.update(N_vo_holdoff=VO_CADENCE,
                        N_vo_update_interval=VO_CADENCE)
    start_path()
    t0 = time.perf_counter()
    # 4b's labeled pool: the labels are solved once
    tr_vo = CreateTrainer(p_vo, *labeled_copies(dl, dlu), device="cuda")
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

    ds_vo = tr_vo.datasets["vo"]
    worst, Y_vo64 = vo_path_checks(
        tr_vo, dl, recipe_params(vo=True).data["vo_spec"],
        fem.make_fom_rom_pair("NDP", 4, 4, 3, device="cpu"),
        p_vo.trainer["N_monte_carlo_vo"])
    errors["apply_stencil"] = (max(errors["apply_stencil"][0], worst),
                               errors["apply_stencil"][1])

    say("  3 f64 SVI steps across a VO refresh (holdoff 1, interval 2), "
        "card vs CPU, same draws")
    elbo3, vo3, state = {}, {}, None
    for run, device in (("card", "cuda"), ("cpu", "cpu")):
        p64 = recipe_params("float64", vo=True)
        p64.trainer.update(N_monitor_interval=0, N_PE_updates_final=0,
                           N_vo_holdoff=1, N_vo_update_interval=2)
        tr = CreateTrainer(p64, *labeled_copies(dl, dlu), device=device)
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
    # the profiler's own post-processing takes ~1 s a profiled step on a
    # slow host, so its windows are shorter than the timed runs
    busy_svi = report_profile(f"{PROFILED_STEPS} SVI steps",
                              lambda: svi_steps(PROFILED_STEPS),
                              svi_wall_ms * PROFILED_STEPS / 100)
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
    # a window of half a cadence with its refresh a quarter cadence in
    vo_steps((VO_CADENCE - VO_CADENCE // 4 - tr_vo.gn) % VO_CADENCE)
    n_prof = VO_CADENCE // 2
    n_ref_prof = sum(1 for g in range(tr_vo.gn, tr_vo.gn + n_prof)
                     if g % VO_CADENCE == 0)
    busy_vo_svi = report_profile(
        f"{n_prof} VO SVI steps ({n_ref_prof} refresh)",
        lambda: vo_steps(n_prof), n_prof * vo_step_ms)


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
    say(f"  pool drawn in {draw_s:.2f} s (KL, {dl_hr.X.shape[0]} fields; "
        f"eigh on the card); V-cycle {solver_hr.mg.num_levels} levels, "
        f"{solver_hr.mg.launches_per_cycle} fused launches and no K1 per "
        f"cycle, maxiter {solver_hr.maxiter}")
    bce_hr = fem.BoundaryConditionEnsemble.from_factory(
        "ND", X_hr.shape[0], np.random.default_rng(0))
    bce_hr.register_function_space("fom", fom_hr.grid)
    bce_hr.register_function_space("rom", phys_hr["rom"].grid)

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
        say(f"  {dtype}: {k} PCG iterations, launches {counts}, true "
            f"relative residual max {res:.3e}, "
            f"{hr[dtype]['ms_first']:.1f} ms (first call)")
        check_launches(f"the MG solve {dtype}", counts, mg_rows(
            None, solver_hr.mg, MG_NODES, X_hr.shape[0],
            str(dtype).split(".")[-1], k))
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
    # the V-cycle's steps on every level of this batch, bit for bit
    # against their plain versions
    for dtype in hr:
        shapes = vcycle_levels_check(dataclasses.replace(
            solver_hr.mg, dtype=str(dtype).split(".")[-1]),
            hr[dtype]["alphas"], gen)
        say(f"  the V-cycle's steps bit-equal to their plain versions on "
            f"every level {dtype}: {shapes}")
    with plain_applies() as plain:
        Y_plain_hr = fom_hr.solve_batched(hr[torch.float32]["alphas"],
                                          hr[torch.float32]["vals"])
    if plain.launched:
        raise AssertionError(f"the plain-path MG solve launched "
                             f"{plain.launched}")
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
    say(f"  {k} forward + {kadj} adjoint iterations, launches {counts}")
    check_launches("the MG VJP", counts, [
        r for n in (k, kadj) for r in mg_rows(
            "7b MG VJP", mg_solver.mg, MG_NODES, HR_VJP_B, "float64", n)])
    mg_vjp_launches = counts
    with plain_applies() as plain:
        _, pa, pb, _ = solve_grads(fom_hr, a64, v64, w_hr, False)
    if plain.launched:
        raise AssertionError(f"the plain-path MG VJP launched "
                             f"{plain.launched}")
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
    busy_hr_svi = report_profile(f"{PROFILED_STEPS} 'highres' SVI steps",
                                 lambda: hr_steps(PROFILED_STEPS),
                                 PROFILED_STEPS * hr_step_ms)

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


    # (9-11 run before phase 8, which checks K1 at every shape the paths
    # used)
    c3 = phase9_config3(card, gen, start_path, end_path, report_profile)
    c3_label_iters, mg_c3 = c3["label_iterations"], c3["mg"]
    c10 = phase10_persistence(card, c3, start_path, end_path,
                              report_profile)
    c2 = c10["config2"]
    del c3["loaders"]
    errors["apply_stencil"] = (max(errors["apply_stencil"][0],
                                   c2["k1_worst_abs"]),
                               errors["apply_stencil"][1])
    c5 = phase11_config5(card, start_path, end_path, report_profile)
    c4 = phase12_config4(card, gen, start_path, end_path, report_profile)
    c512 = phase13_config512(card, gen, start_path, end_path,
                             report_profile)
    c14 = phase14_vo_configs(card, start_path, end_path, report_profile)
    for c in c14.values():
        errors["apply_stencil"] = (max(errors["apply_stencil"][0],
                                       c["k1_worst_abs"]),
                                   errors["apply_stencil"][1])
    d15, c15 = phase15_api(card, start_path, end_path, report_profile)
    d16, c16 = phase16_sharded(card, dl, dlu, start_path, end_path, add_path)
    d17, c17 = phase17_options(card, c10.pop("resumed"), dl, dlu,
                               start_path, end_path)

    # ------------- 8. K1, K2 and the V-cycle's steps at every main-path shape
    say("phase 8: K1, K2 and the V-cycle's steps at every shape of the "
        "main paths: launches, bit-equality, times; K3's launches per shape")
    mg = solver_hr.mg
    if mg.num_levels != len(MG_NODES):
        raise AssertionError(f"the V-cycle has {mg.num_levels} levels")

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
        derived += mg_rows(path, mg, MG_NODES, B, dname, k)
    for k in c3_label_iters:
        derived += mg_rows("9 config3 train", mg_c3, MG128_NODES,
                           C3_LABEL_BATCH, "float64", k)
    # config 2: its label dispatch under the V-cycle, and one constraint
    # assembly at set-up and one per refresh on the 64 VO fields
    for k in c2["label_iterations"]:
        derived += mg_rows("10d config2", c2["mg"], MG_NODES, C2_LABEL_BATCH,
                           "float64", k)
    derived.append(("10d config2", "apply_stencil", MG_NODES[0], C2_VO,
                    "float32",
                    c2["k1_per_assembly"] * (1 + len(c2["refreshes"]))))
    # config 5: the cold and the warm sweep, each one MG-PCG of all systems
    for k in c5["iterations"].values():
        derived += mg_rows("11 config5 sweep", c5["mg"], MG_NODES,
                           C5_SYSTEMS, "float32", k)
    # configs 4 and 512: their label dispatches under the 7- and 8-level
    # V-cycles
    for path, cfg, nodes, B in (("12 config4", c4, MG256_NODES,
                                 C4_LABEL_BATCH),
                                ("13 config512", c512, MG512_NODES,
                                 C512_LABEL_BATCH)):
        for k in cfg["label_iterations"]:
            derived += mg_rows(path, cfg["mg"], nodes, B, "float64", k)
    # the VO configs: their label dispatches, and the VO applies on the 64
    # VO fields (energy: per update; constrain: an assembly at set-up and
    # one per refresh)
    for c, cfg in c14.items():
        path = f"14 config{c}"
        levels = MG_NODES if cfg["nodes"] == MG_NODES[0] else MG128_NODES
        for k in cfg["label_iterations"]:
            derived += mg_rows(path, cfg["mg"], levels, cfg["label_batch"],
                               "float64", k)
        derived.append((path, "apply_stencil", cfg["nodes"], C2_VO,
                        "float32", cfg["k1_per_refresh"]
                        * (len(cfg["refreshes"]) + (not cfg["energy"]))))
    # phase 15: one rhs apply and one matvec per PCG iteration of each
    # single-system forward, adjoint and vmap solve
    derived += d15
    # phase 16: the lifecycle's label dispatches (each process's and the
    # one process's), the ablation's MG labels and VO applies
    derived += d16
    # phase 17: the bf16 V-cycle's levels and f32 matvecs, the BCE-encoded
    # label dispatch
    derived += d17
    # K3: phase 6's chain at its first shape (padded nodes), no other path
    k3 = apply_stencil_sym_blocked.__name__
    derived.append((K3_CHAIN_PATH, k3, *K3_SHAPES[0], K3_CHAIN))
    shape_launches = {}
    for path, counts in path_launches.items():
        check_launches(f"path {path!r}", counts,
                       [r for r in derived if r[0] == path])
    for _, kname, nodes, B, dname, count in derived:
        if kname == k3 or not count:
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
    listed = {(k, *sh) for k, shapes in (*STENCIL_SHAPES.items(),
                                         *VCYCLE_SHAPES.items())
              for sh in shapes}
    if set(shape_launches) != listed:
        raise AssertionError(f"main-path shapes {sorted(shape_launches)} "
                             f"differ from STENCIL_SHAPES and VCYCLE_SHAPES")
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
    for kname, (rows, times) in vcycle_shape_rows(shape_launches, mg, cgen,
                                                  flush).items():
        shape_rows[kname], timing[kname] = rows, times
        errors[kname] = (0.0, 0.0)  # bit-equal at every shape
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
          "config3_mg": {
              "label_solve_ms": c3["label_ms"],
              "label_solve_warm_ms": c3["label_warm_ms"],
              "dispatch_solve_ms": c3["solve_ms"],
              "pcg_iterations": c3_label_iters,
              "launches": c3["label_launches"],
              "true_residual": c3["label_residual"]},
          "vo": {
              "launches_per_refresh": k1_per_assembly,
              "refresh_ms": refresh_ms, "propagation_ms": prop_ms,
              "resample_ms": resample_ms, "conditioning_ms": cond_ms,
              "energy_update_launches": energy_counts["apply_stencil"],
              "energy_update_ms": energy_ms},
          "config2_vo": {k: c2[k] for k in (
              "label_iterations", "refreshes", "k1_per_assembly",
              "refresh_ms", "propagation_ms", "resample_ms",
              "conditioning_ms")},
          "config5_mg": {k: c5[k] for k in (
              "iterations", "launches", "seconds")},
          **{f"config{name}_mg": {
              "label_ms": cfg["label_ms"],
              "pcg_iterations": cfg["label_iterations"],
              "launches": cfg["launches"],
              "true_residual": cfg["label_residual"]}
             for name, cfg in (("4", c4), ("512", c512))},
          **{f"config{c}_vo": {
              "label_iterations": cfg["label_iterations"],
              "refreshes": cfg["refreshes"],
              "k1_per_refresh": cfg["k1_per_refresh"],
              "refresh_ms": cfg["refresh_ms"],
              "propagation_ms": cfg["propagation_ms"],
              "update_ms": cfg["update_ms"]} for c, cfg in c14.items()},
          "phase16": {
              "launches_by_path": {
                  p: sum(r[5] for r in d16 if r[0] == p)
                  for p in sorted({r[0] for r in d16})},
              "launches_by_shape": {
                  f"{n},{n},{B} {d}": sum(r[5] for r in d16
                                         if r[2:5] == (n, B, d))
                  for n, B, d in sorted({r[2:5] for r in d16})}},
          "phase15": {
              "launches_by_shape": {
                  f"{n},{n},{B} {d}": sum(r[5] for r in d15
                                         if r[2:5] == (n, B, d))
                  for n, B, d in sorted({r[2:5] for r in d15})},
              **{k: c15[k] for k in ("single", "vmap", "forcing")}},
          "phase17": {k: c17[k] for k in (
              "bf16_vcycle", "high_contrast", "bce_encoding")}}),
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
        # the V-cycle's steps, no TPU counterpart (the JAX package's
        # V-cycle is XLA operations); times at config 5's levels in f32
        *((name, "vcycle.cuh", None, None,
           {"launches_per_cycle": mg.launches_per_cycle,
            "timed_at": {k: timing[name][k] for k in ("shape", "dtype")}})
          for name in FUSED),
    ]
    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": src + source,
        "replaces": replaces,
        "tpu": None if body is None else f"ops/stencil.py:{body}",
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
            "svi_config3": {k: c3[k] for k in (
                "steps_per_s", "busy_share", "peak_gb",
                "peak_gb_above_start", "unsup_bf16_rel",
                "card_vs_cpu_elbo_rel", "card_vs_cpu_param_rel",
                "results")},
            "svi_config2": {k: c2[k] for k in (
                "steps_per_s", "busy_share", "results")},
            "uncertainty_sweep_config5": {
                k: v for k, v in c5.items() if k != "mg"},
            "svi_config4": {k: v for k, v in c4.items() if k != "mg"},
            "svi_config512": {k: v for k, v in c512.items() if k != "mg"},
            **{f"svi_config{c}": {k: v for k, v in cfg.items()
                                  if k != "mg"} for c, cfg in c14.items()},
            "persistence": {**c10["resume"], **c10["export"]},
            "api_phase15": {k: c15[k] for k in (
                "calibration", "dense_ed", "cache", "analysis", "seconds")},
            "sharded_phase16": c16,
            "options_phase17": {k: c17[k] for k in (
                "bundle", "profile", "phase_s")},
            "predict_ms": {str(b): t for b, t in predict_ms.items()}}}
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter() - _T0]
    say("seconds per phase: " + ", ".join(
        f"{name.split(' ', 1)[1]} {end - t:.1f}"
        for (name, t), end in zip(PHASE_STARTS, ends)))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase16-child"]:
        sys.exit(phase16_child(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4], sys.argv[5]))
    sys.exit(main())
