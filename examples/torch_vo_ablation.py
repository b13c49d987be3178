#!/usr/bin/env python
"""The virtual-observables ablation on the PyTorch port.

The port's counterpart of ``examples/vo_ablation.py``: three arms at
EQUAL labeled budget (N_s = 64), equal unlabeled budget (N_u = 1024,
amortized, batch 64), equal iterations, identical data permutations and
an IDENTICAL held-out validation set (the vo partition slot is reserved
in every arm, so the validation fields are the same 64 samples):

  a "labels"    : no virtual observables -- the 64 VO fields are unused
  b "constrain" : + N_vo = 64 fields with linear-Gaussian constraint VO
                  (CGR + flux + Gaussian sketch + RBF, the config-2 spec)
  c "energy"    : + N_vo = 64 fields with annealed randomized-subspace
                  energy VO

on the 'highres' 64^2 recipe (FFT fields, labels under the multigrid
V-cycle on the CUDA stencil kernel).  ``--ns N`` sweeps the labeled
budget (``--ns 0`` is the zero-label regime).

    python examples/torch_vo_ablation.py [iterations] [arm] [--ns N]
        [--cadence C]      constrain-arm VO holdoff + update interval
        [--corrlength L]   field correlation length (default 0.04)
        [--temper F]       constrain-arm prior_precision_factor

Default: all three arms for 4000 iterations each, in turn, on the card;
the results are appended to ``results/torch_vo_ablation.json`` (relative
to the working directory; a row of the same arm, options and N_s is
replaced) and a summary table is printed.  ``run_arm`` runs one arm and
writes nothing.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from generative_physics_informed_pde_tpu_torch.data import DataLoader  # noqa: E402
from generative_physics_informed_pde_tpu_torch.fem import (  # noqa: E402
    GaussianRandomField)
from generative_physics_informed_pde_tpu_torch.training import (  # noqa: E402
    CreateTrainerFromPermutation, TrainerParameters)

# The recipe's pools and batch: VO fields, validation fields, unlabeled
# fields, amortized batch.
N_VO, N_VAL, N_U, BATCH = 64, 64, 1024, 64
RESULTS = os.path.join("results", "torch_vo_ablation.json")


def _params(iterations: int, arm: str, n_s: int,
            vo_cadence: int | None = None,
            temper: float = 1.0) -> TrainerParameters:
    p = TrainerParameters()
    p.identifier = "highres"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=500)
    p.scheduler = {"milestones": [iterations // 4, (5 * iterations) // 8],
                   "factor": math.sqrt(0.1)}
    # N_vo_max in EVERY arm: the vo partition slot stays reserved so
    # supervised/validation index into identical fields across arms
    p.data.update(N_u=N_U, N_s=n_s, N_u_max=N_U, N_s_max=n_s, N_vo_max=N_VO,
                  N_val=N_VAL, armortized_bs=BATCH)
    if arm == "labels":
        p.data.update(N_vo=0, vo_spec={})
    elif arm == "constrain":
        c = vo_cadence or 250
        p.trainer.update(N_vo_holdoff=c, N_vo_update_interval=c,
                         N_monte_carlo_vo=64)
        p.data.update(N_vo=N_VO,
                      vo_spec={"type": "constrain", "CGR": True,
                               "flux": True, "N_gaussian": 8, "N_rbf": 8,
                               "l_rbf": 0.2,
                               "prior_precision_factor": temper})
    elif arm == "energy":
        p.trainer.update(N_vo_holdoff=50, N_vo_update_interval=10,
                         N_monte_carlo_vo=64)
        p.data.update(N_vo=N_VO,
                      vo_spec={"type": "energy", "l_rbf": 0.2, "N_rbf": 32,
                               "energy_num_iterations_per_update": 10,
                               "T_init": 1.0, "T_final": 1e-6,
                               "T_iterations": iterations + 1})
    else:
        raise ValueError(arm)
    return p


def _tag(arm: str, vo_cadence: int | None, temper: float,
         corrlength: float) -> str:
    """The arm's name in the results file, with the options it ran
    under (the JAX example's tagging, as ``main`` applies it)."""
    tag = f"{arm}@{vo_cadence}" if vo_cadence else arm
    if temper != 1.0:
        tag = f"{tag}*t{temper}"
    if corrlength != 0.04:
        tag = f"{tag}/l{corrlength}"
    return tag


def _tagged(out: dict, vo_cadence: int | None, temper: float,
            corrlength: float) -> dict:
    """A result row of arm ``out['arm']`` tagged with the options it ran
    under.  --cadence / --temper are wired into the constrain arm only
    (_params ignores them elsewhere): tagging unaffected arms would
    record the identical labels/energy config twice under different
    names."""
    out = dict(out)
    arm = out["arm"]
    if vo_cadence and arm == "constrain":
        out["vo_cadence"] = vo_cadence
        out["arm"] = f"{arm}@{vo_cadence}"
    if temper != 1.0 and arm == "constrain":
        out["temper"] = temper
        out["arm"] = f"{out['arm']}*t{temper}"
    if corrlength != 0.04:
        out["corrlength"] = corrlength
        out["arm"] = f"{out['arm']}/l{corrlength}"
    return out


def run_arm(arm: str, iterations: int, n_s: int = 64,
            vo_cadence: int | None = None, corrlength: float = 0.04,
            temper: float = 1.0, device="cuda") -> dict:
    """Train one arm on ``device`` and return its final metrics
    (``Trainer.results``) with the arm, iterations, N_s and steps/s;
    writes nothing."""
    # fresh loaders per arm, SAME keys -> identical fields and labels
    rf = GaussianRandomField.from_image(64, 64, 0.4, 0.8, corrlength,
                                        method="fft")
    dl = DataLoader.from_sampler(rf, n_s + N_VO + N_VAL, key=0,
                                 device=device)
    dlu = DataLoader.from_sampler(rf, N_U, key=1, device=device)
    dlu.lock_physics_assembly()

    p = _params(iterations, arm, n_s, vo_cadence, temper)
    t0 = time.time()
    tr = CreateTrainerFromPermutation(p, permutation=np.arange(dl.N),
                                      permutation_u=np.arange(dlu.N),
                                      dl=dl, dlu=dlu, device=device)
    print(f"[{arm}] setup: {time.time() - t0:.1f}s", flush=True)
    t0 = time.time()
    tr.run(iterations, verbose=True)
    dt = time.time() - t0
    out = dict(tr.results())
    out.update(arm=arm, iterations=iterations, N_s=n_s,
               steps_per_sec=iterations / dt)
    out = _tagged(out, vo_cadence, temper, corrlength)
    print(f"[{arm}] {iterations} iters in {dt:.1f}s "
          f"({out['steps_per_sec']:.2f} steps/s): {out}", flush=True)
    return out


def _option(argv: list, name: str, cast, default):
    if name in argv:
        i = argv.index(name)
        value = cast(argv[i + 1])
        del argv[i:i + 2]
        return value
    return default


def main(argv=None, device="cuda", path: str = RESULTS) -> list:
    """Run the arms of ``argv`` (default ``sys.argv[1:]``), accumulating
    into ``path``; returns the results list."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n_s = _option(argv, "--ns", int, 64)
    vo_cadence = _option(argv, "--cadence", int, None)
    corrlength = _option(argv, "--corrlength", float, 0.04)
    temper = _option(argv, "--temper", float, 1.0)
    iterations = int(argv[0]) if argv else 4000
    arms = [argv[1]] if len(argv) > 1 else ["labels", "constrain", "energy"]
    results = []
    if os.path.exists(path):
        with open(path) as fh:
            results = json.load(fh)  # accumulate across runs
    for arm in arms:
        tag = _tag(arm, vo_cadence, temper, corrlength)
        results = [r for r in results
                   if not (r["arm"] == tag and r.get("N_s", 64) == n_s)]
        results.append(run_arm(arm, iterations, n_s, vo_cadence, corrlength,
                               temper, device=device))
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as fh:
            json.dump(results, fh, indent=1)
    print(f"\n{'arm':<18} {'N_s':>4} {'rel-L2':>8} {'r2_y':>8} "
          f"{'logscore':>9}")
    for r in sorted(results, key=lambda r: (r.get("N_s", 64), r["arm"])):
        print(f"{r['arm']:<18} {r.get('N_s', 64):>4} {r['relerr_y']:>8.4f} "
              f"{r['r2_y']:>8.4f} {r['logscore_y']:>9.3f}")
    return results


if __name__ == "__main__":
    main()
