"""Labelling pools of fields back to back (BASELINE config 3's labelled
pool), one client.

Set-up draws ``distinct_pools`` pools of ``pool`` float64 fields of the
configuration's field (on the device, kept on the host as the loader
keeps them) and builds the physics that config 3's trainer builds.  The
pools are the same for every seed (drawn from ``pool_set_seed``): how
many PCG iterations a dispatch takes depends on its fields, so pools
drawn from ``--seed`` made the seed change the work.  ``--seed``
orders them and picks the pool that is checked.  The window labels the
pools in that order, cycling, in a closed loop:
``DataLoader(X).assemble(physics)``,
which draws each field's 'NDP' boundary encoding from the fields' hash,
solves the labels in float64 dispatches and hands back ``X_DG``, ``Y`` and
``F_ROM_BC`` on the host.  After the window one pool, drawn from the seed,
is checked against the plain reference: every label, ``X_DG`` and
``F_ROM_BC``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import fields
from portbench.reference import fem as ref


def program_physics(ctx):
    """The fom/rom physics of config 3's model preset, as its trainer
    builds them."""
    from generative_physics_informed_pde_tpu_torch.factories import (
        ModelFactory)

    if ctx.on_card:
        from generative_physics_informed_pde_tpu_torch.ops import _build

        _build.build_all(["stencil"])
    m = ctx.config["model"]
    mf = ModelFactory.FromIdentifier(m["preset"], nx_rom=m["nx_rom"],
                                     ny_rom=m["ny_rom"],
                                     num_refines=m["num_refines"])
    return mf.physics(device=ctx.device)


def draw_pool(ctx, count: int, index: int, seed=None) -> np.ndarray:
    """(count, n, n) float64 fields of the configuration's field, drawn on
    the device from ``seed`` (default the run's) and ``index``, on the
    host."""
    f, n = ctx.config["field"], ctx.config["model"]["grid"]
    seed = ctx.seed if seed is None else seed
    return fields.sample(n, count, mean=f["mean"], stddev=f["stddev"],
                         corrlength=f["corrlength"], kernel=f["kernel"],
                         gen=fields.generator(seed, index, ctx.device),
                         dtype=torch.float64).cpu().numpy()


def reference_labels(ctx, X: np.ndarray, dtype=torch.float64) -> dict:
    """The plain reference's products of the fields ``X`` in ``dtype``:
    labels, cell values and coarse forces."""
    tr = ctx.traffic["reference"]
    f64 = dtype == torch.float64
    Xd = X if f64 else X.astype(np.float32)
    theta = ref.ndp_thetas(X)
    u, _ = ref.solve(torch.as_tensor(Xd, device=ctx.device),
                     torch.as_tensor(theta, device=ctx.device, dtype=dtype),
                     tol=tr["tol"] if f64 else tr["control_tol"],
                     maxiter=20000 if f64 else tr["control_maxiter"])
    n_rom = ctx.config["model"]["nx_rom"]
    return {"Y": ref.free_values(u).double().cpu().numpy(),
            "X_DG": ref.cell_values(Xd).astype(np.float64),
            "F_ROM_BC": ref.rom_force(theta, n_rom).astype(Xd.dtype
                                                           ).astype(np.float64)}


def compare(got: dict, want: dict) -> dict:
    """The worst label's relative error; the largest differences of the
    cell values (exact) and of the coarse forces."""
    Y, Yr = np.asarray(got["Y"], np.float64), want["Y"]
    lab = float(np.max(np.linalg.norm(Y - Yr, axis=1)
                       / np.linalg.norm(Yr, axis=1)))
    return {"label_rel_err": lab,
            "x_dg_abs_err": float(np.max(np.abs(
                np.asarray(got["X_DG"], np.float64) - want["X_DG"]))),
            "f_rom_bc_abs_err": float(np.max(np.abs(
                np.asarray(got["F_ROM_BC"], np.float64) - want["F_ROM_BC"])))}


def run(ctx):
    from generative_physics_informed_pde_tpu_torch.data import DataLoader

    tr = ctx.traffic
    phys = program_physics(ctx)
    rng = np.random.default_rng(ctx.seed)
    order = rng.permutation(tr["distinct_pools"])
    pools = [draw_pool(ctx, tr["pool"], int(k), seed=tr["pool_set_seed"])
             for k in order]
    checked = int(rng.integers(tr["checked_pool_below"]))

    def label(X):
        dl = DataLoader(X)
        dl.assemble(phys)
        return dl

    for k in range(tr["warmup_pools"]):
        label(pools[k % len(pools)])
    ctx.start_window()
    t_start = time.perf_counter()
    its, kept, bad, k = [], None, 0, 0
    while True:
        dl = label(pools[k % len(pools)])
        its += [int(i) for i in dl.label_iterations]
        if not np.isfinite(dl.Y).all():
            bad += 1
        if k == checked:
            kept = (k, dl)
        k += 1
        if time.perf_counter() - t_start >= ctx.seconds:
            break
    window = time.perf_counter() - t_start
    peak = ctx.window_peak()
    if kept is None:  # a window too short for the drawn pool: the last
        kept = (k - 1, dl)
    ctx.attempted, ctx.failed = k, bad
    ctx.e2e = {"label_fields_per_s": k * tr["pool"] / window}
    ctx.counters = {"pcg_iterations": its, "pools": k, "window_s": window,
                    "window_peak_bytes": peak}
    if ctx.trace:
        n_tr = tr["traced_iterations"]

        def traced():
            for j in range(n_tr):
                label(pools[j % len(pools)])

        ctx.profile(traced, n_tr)

    j, dl = kept
    got = {"Y": dl.Y, "X_DG": dl.X_DG, "F_ROM_BC": dl.F_ROM_BC}
    X = pools[j % len(pools)]
    del pools, phys
    want = reference_labels(ctx, X)
    for name, value in compare(got, want).items():
        ctx.check(name, value, tr["limits"][name])
    ctx.kept = {"X": X, "want": want}


def control(ctx) -> dict:
    """The numbers of the control: the plain reference in the program's
    place, computed in float32 (the precision below the configuration's
    float64 labels), on the checked pool."""
    k = ctx.kept
    return compare(reference_labels(ctx, k["X"], torch.float32), k["want"])
