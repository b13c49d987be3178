#!/usr/bin/env python
"""The BASELINE configurations built from the PyTorch port.

    python examples/torch_baseline_configs.py <config> [iterations]

The recipes of ``examples/baseline_configs.py`` (configs 1, 2, 2e, 2h,
2he, 3, 4, 5 and 512), built from ``generative_physics_informed_pde_tpu_
torch`` on the card (``device="cuda"``); each config function also takes
``device="cpu"``.  The pools come from the port's random fields through
``DataLoader.from_sampler`` (keys 0 and 1, drawn on the device: the same
pool on every run on one device type, another on the CPU, and not the JAX
package's pool, whose random stream differs).  Long runs
train in segments and checkpoint after each one to ``ckpt_dir/latest.pt``
(relative to the working directory); started again with the same
arguments, a run resumes from there.  Imports nothing of JAX.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_uncertainty_study  # noqa: E402
from generative_physics_informed_pde_tpu_torch.constraints import (  # noqa: E402
    vo_spec_preset)
from generative_physics_informed_pde_tpu_torch.data import DataLoader  # noqa: E402
from generative_physics_informed_pde_tpu_torch.fem import (  # noqa: E402
    GaussianRandomField)
from generative_physics_informed_pde_tpu_torch.training import (  # noqa: E402
    CreateTrainerFromPermutation, TrainerParameters)

CHECKPOINT = "latest.pt"


def _loaders(rf, n_labeled, n_unlabeled, seed=0, device="cuda"):
    dl = DataLoader.from_sampler(rf, n_labeled, key=seed, device=device)
    dlu = DataLoader.from_sampler(rf, n_unlabeled, key=seed + 1,
                                  device=device)
    dlu.lock_physics_assembly()
    return dl, dlu


def _run(params, dl, dlu, iterations, ckpt_dir=None, seg=None,
         device="cuda"):
    """Run the trainer to ``iterations``; with ``ckpt_dir`` set, in
    ``seg``-iteration segments with a checkpoint after each, resuming from
    ``ckpt_dir/latest.pt`` when it exists."""
    t0 = time.time()
    tr = CreateTrainerFromPermutation(params, permutation=np.arange(dl.N),
                                      permutation_u=np.arange(dlu.N),
                                      dl=dl, dlu=dlu, device=device)
    print(f"setup: {time.time() - t0:.1f}s", flush=True)
    tr.info()
    ckpt = os.path.join(ckpt_dir, CHECKPOINT) if ckpt_dir else None
    if ckpt and os.path.isfile(ckpt):
        tr.restore_checkpoint(ckpt)
        print(f"resumed from {ckpt_dir} at gn={tr.gn}", flush=True)
    t0 = time.time()
    seg = seg or iterations
    gn0 = tr.gn  # nonzero on a resume
    while tr.gn < iterations:
        n = min(seg, iterations - tr.gn)
        tr.run(n, verbose=True)
        if ckpt:
            os.makedirs(ckpt_dir, exist_ok=True)
            tr.save_checkpoint(ckpt)
            print(f"checkpoint @ gn={tr.gn}: {tr.results()}", flush=True)
    dt = time.time() - t0
    done = tr.gn - gn0  # the iterations run by this call
    if done > 0:
        print(f"{done} iters in {dt:.1f}s -> {done / dt:.1f} steps/s"
              + (f" (resumed at gn={gn0})" if gn0 else ""), flush=True)
    print("results:", tr.results(), flush=True)
    return tr


def config1(iterations=15000, device="cuda"):
    """Fully labeled 32^2 (the example recipe with N_u=0)."""
    p = TrainerParameters()
    p.identifier = "highres32"
    p.trainer.update(lr_init=1e-2, N_monitor_interval=1000)
    p.scheduler = {"milestones": [250, 1500], "factor": math.sqrt(0.1)}
    p.data.update(N_u=0, N_s=128, N_u_max=0, N_s_max=128, N_vo_max=0,
                  N_vo=0, N_val=128, armortized_bs=None, vo_spec={})
    rf = GaussianRandomField.from_image(32, 32, 0.4, 0.8, 0.15)
    dl, dlu = _loaders(rf, 256, 1, device=device)
    return _run(p, dl, dlu, iterations, device=device)


def config2(iterations=3000, cadence=None, device="cuda"):
    """Semi-supervised 64^2 with virtual observables: 64 labeled + 1024
    unlabeled + 64 VO-constrained fields, at the package's VO cadence (50;
    ``cadence=250`` for the reference's)."""
    p = TrainerParameters()
    p.identifier = "highres"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=500,
                     N_vo_holdoff=250, N_monte_carlo_vo=64)
    if cadence is not None:
        p.trainer["N_vo_update_interval"] = cadence
    p.scheduler = {"milestones": [500, 1500], "factor": math.sqrt(0.1)}
    p.data.update(N_u=1024, N_s=64, N_u_max=1024, N_s_max=64, N_vo_max=64,
                  N_vo=64, N_val=64, armortized_bs=64,
                  vo_spec=vo_spec_preset("constrain"))
    rf = GaussianRandomField.from_image(64, 64, 0.4, 0.8, 0.04, method="fft")
    dl, dlu = _loaders(rf, 64 + 64 + 64, 1024, device=device)
    return _run(p, dl, dlu, iterations, device=device)


def config2e(iterations=1000, device="cuda"):
    """Config 2 with energy virtual observables (annealed randomized-
    subspace energy minimisation instead of linear-Gaussian
    conditioning)."""
    p = TrainerParameters()
    p.identifier = "highres"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=250,
                     N_vo_holdoff=50, N_vo_update_interval=10,
                     N_monte_carlo_vo=64)
    p.scheduler = {"milestones": [500, 1500], "factor": math.sqrt(0.1)}
    p.data.update(N_u=1024, N_s=64, N_u_max=1024, N_s_max=64, N_vo_max=64,
                  N_vo=64, N_val=64, armortized_bs=64,
                  vo_spec=vo_spec_preset("energy", T_iterations=iterations + 1))
    rf = GaussianRandomField.from_image(64, 64, 0.4, 0.8, 0.04, method="fft")
    dl, dlu = _loaders(rf, 64 + 64 + 64, 1024, device=device)
    return _run(p, dl, dlu, iterations, device=device)


def config2h(iterations=1000, device="cuda"):
    """Config 2's virtual observables at 128^2 (16,129 free dofs)."""
    p = TrainerParameters()
    p.identifier = "highres128"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=250,
                     N_vo_holdoff=250, N_monte_carlo_vo=64)
    p.scheduler = {"milestones": [iterations // 2], "factor": math.sqrt(0.1)}
    p.data.update(N_u=1024, N_s=64, N_u_max=1024, N_s_max=64, N_vo_max=64,
                  N_vo=64, N_val=64, armortized_bs=32,
                  vo_spec=vo_spec_preset("constrain"))
    rf = GaussianRandomField.from_image(128, 128, 0.4, 0.8, 0.04,
                                        method="fft")
    dl, dlu = _loaders(rf, 64 + 64 + 64, 1024, device=device)
    return _run(p, dl, dlu, iterations, device=device)


def config2he(iterations=2000, device="cuda",
              ckpt_dir="results/config2he_ckpt"):
    """Energy virtual observables at 128^2; runs above 1000 iterations
    checkpoint every 1000 to ``ckpt_dir``."""
    p = TrainerParameters()
    p.identifier = "highres128"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=500,
                     N_vo_holdoff=50, N_vo_update_interval=10,
                     N_monte_carlo_vo=64)
    if iterations > 1000:
        p.scheduler = {"milestones": [iterations // 3, 2 * iterations // 3],
                       "factor": math.sqrt(0.1)}
    else:
        p.scheduler = {"milestones": [500], "factor": math.sqrt(0.1)}
    p.data.update(N_u=1024, N_s=64, N_u_max=1024, N_s_max=64, N_vo_max=64,
                  N_vo=64, N_val=64, armortized_bs=32,
                  vo_spec=vo_spec_preset("energy", T_iterations=iterations + 1))
    rf = GaussianRandomField.from_image(128, 128, 0.4, 0.8, 0.04,
                                        method="fft")
    dl, dlu = _loaders(rf, 64 + 64 + 64, 1024, device=device)
    ckpt = ckpt_dir if iterations > 1000 else None
    return _run(p, dl, dlu, iterations, ckpt_dir=ckpt, seg=1000,
                device=device)


def config3(iterations=600, device="cuda"):
    """High-contrast Matern-3/2 at 128^2 with 16 MC ELBO samples a step;
    above 1000 iterations the lr decays at the thirds and the run
    checkpoints every 1000 to results/config3_ckpt."""
    p = TrainerParameters()
    p.identifier = "highres128"
    p.trainer.update(lr_init=1e-3, N_monitor_interval=200,
                     N_monte_carlo_elbo=16, N_monte_carlo_analysis=16)
    if iterations > 1000:
        p.scheduler = {"milestones": [iterations // 3, 2 * iterations // 3],
                       "factor": math.sqrt(0.1)}
    else:
        p.scheduler = {"milestones": [400], "factor": 0.5}
    p.data.update(N_u=256, N_s=128, N_u_max=256, N_s_max=128, N_vo_max=0,
                  N_vo=0, N_val=64, armortized_bs=32, vo_spec={})
    rf = GaussianRandomField.from_image(128, 128, 0.4, 1.0, 0.08,
                                        method="fft", kernel="matern32")
    dl, dlu = _loaders(rf, 128 + 64, 256, device=device)
    ckpt = "results/config3_ckpt" if iterations > 1000 else None
    return _run(p, dl, dlu, iterations, ckpt_dir=ckpt, seg=1000,
                device=device)


def config4(iterations=2000, device="cuda"):
    """Coarse-model mismatch: an 8^2 ROM against a 256^2 FOM, amortized
    encoder over 10,240 unlabeled fields."""
    p = TrainerParameters()
    p.identifier = "highres128"
    p.margs = {"num_refines": 5, "nx_rom": 8, "ny_rom": 8}  # FOM 256^2
    p.trainer.update(lr_init=1e-3, N_monitor_interval=500)
    p.scheduler = {"milestones": [1000], "factor": 0.5}
    p.data.update(N_u=10240, N_s=64, N_u_max=10240, N_s_max=64, N_vo_max=0,
                  N_vo=0, N_val=32, armortized_bs=32, vo_spec={})
    rf = GaussianRandomField.from_image(256, 256, 0.4, 0.8, 0.08,
                                        method="fft")
    dl, dlu = _loaders(rf, 64 + 32, 10240, device=device)
    return _run(p, dl, dlu, iterations, device=device)


def config512(iterations=3000, device="cuda",
              ckpt_dir="results/config512_ckpt"):
    """Config 4's recipe one octave up: an 8^2 ROM against a 512^2 FOM,
    checkpointing every 500 iterations to ``ckpt_dir``."""
    p = TrainerParameters()
    p.identifier = "highres128"
    p.margs = {"num_refines": 6, "nx_rom": 8, "ny_rom": 8}  # FOM 512^2
    p.trainer.update(lr_init=1e-3, N_monitor_interval=500)
    p.scheduler = {"milestones": [1000, 2000], "factor": 0.5}
    p.data.update(N_u=1024, N_s=64, N_u_max=1024, N_s_max=64, N_vo_max=0,
                  N_vo=0, N_val=32, armortized_bs=16, vo_spec={})
    rf = GaussianRandomField.from_image(512, 512, 0.4, 0.8, 0.08,
                                        method="fft")
    dl, dlu = _loaders(rf, 64 + 32, 1024, device=device)
    return _run(p, dl, dlu, iterations, ckpt_dir=ckpt_dir, seg=500,
                device=device)


def config5(device="cuda"):
    """4096 batched PDE solves a step (an uncertainty-propagation sweep):
    ``examples/torch_uncertainty_study.py`` with 4096 fields per
    correlation length, as the JAX runner runs
    ``examples/uncertainty_study.py 4096``."""
    return torch_uncertainty_study.main(["4096"], device=device)


CONFIGS = {"1": config1, "2": config2, "2e": config2e, "2h": config2h,
           "2he": config2he, "3": config3, "4": config4, "5": config5,
           "512": config512}


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "1"
    args = [int(a) for a in sys.argv[2:3]]
    CONFIGS[which](*args)
