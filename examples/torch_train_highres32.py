#!/usr/bin/env python
"""The highres32 example recipe (``examples/train_highres32.py``) built
from the PyTorch port.

Trains the semi-supervised physics-informed VAE on the 'highres32'
preset: 32x32 Darcy flow with random linear Dirichlet profiles ('NDP'),
128 labeled pairs + 1024 unlabeled fields (amortized encoder, batch 64),
15,000 SVI iterations, Adam 1e-2 with sqrt(0.1) decays at 250/1500, on
the card; metrics go to results/metrics_BasicIllustration.jsonl.

Run:  python examples/torch_train_highres32.py [iterations]
Add --vo to enable virtual observables on 128 extra labeled-pool fields.
From Python, ``main(["200"], device="cpu")`` runs it on the CPU.  The
ELBO and the validation predictions are plotted to results/elbo.png and
results/predictions.png where matplotlib is installed (else "plotting
skipped").  Imports nothing of JAX.
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from generative_physics_informed_pde_tpu_torch.factories.data import (  # noqa: E402
    DataFactory)
from generative_physics_informed_pde_tpu_torch.training import (  # noqa: E402
    CreateTrainer, TrainerParameters)
from generative_physics_informed_pde_tpu_torch.utils.plotting import (  # noqa: E402
    plot_2d, plot_elbo)


def build_params(iterations=15000, use_vo=False) -> TrainerParameters:
    params = TrainerParameters()
    params.folder = "results/"
    params.comment = "BasicIllustration"
    params.identifier = "highres32"
    params.Iterations = iterations

    params.trainer["lr_init"] = 1e-2
    params.trainer["N_PE_updates"] = 3
    params.trainer["N_monte_carlo_analysis"] = 64
    params.trainer["N_monte_carlo_analysis_final"] = 1024
    params.trainer["N_monitor_interval"] = 1000
    params.trainer["N_PE_updates_final"] = 250
    params.trainer["N_tensorboard_logging_interval"] = 1000
    # the reference's cadence; the package default is 50
    params.trainer["N_vo_update_interval"] = 250
    params.trainer["N_vo_holdoff"] = 250
    params.trainer["N_monte_carlo_vo"] = 128

    params.margs["dim_latent"] = 16
    params.margs["ptype"] = "NDP"

    params.scheduler["milestones"] = [250, 1500]
    params.scheduler["factor"] = math.sqrt(0.1)

    params.data["N_u"] = 1024
    params.data["N_s"] = 128
    params.data["N_u_max"] = 2048
    params.data["N_s_max"] = 128
    params.data["N_vo_max"] = 128
    params.data["N_vo"] = 128 if use_vo else 0
    params.data["N_val"] = 128
    params.data["armortized_bs"] = 64
    params.data["vo_spec"] = (
        {"type": "constrain", "CGR": True, "flux": True, "N_gaussian": 8,
         "N_rbf": 8, "l_rbf": 0.2} if use_vo else {})
    return params


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("-")]
    params = build_params(int(args[0]) if args else 15000, "--vo" in argv)

    dl, dlu = DataFactory.FromIdentifier(params.identifier).setup(
        N_u_max=params.data["N_u_max"], device=device)
    trainer = CreateTrainer(params, dl, dlu, device=device)
    trainer.info()
    trainer.run(params.Iterations, verbose=True)

    results = trainer.results()
    print(f"Achieved r2_y: {results['r2_y']}")
    print(f"Achieved relative error: {results['relerr_y']}")
    print(f"Achieved predictive logscore: {results['logscore_y']}")

    try:
        import matplotlib
        matplotlib.use("Agg")
        plot_elbo(trainer, figsize=(6, 4))
        import matplotlib.pyplot as plt
        plt.savefig("results/elbo.png")
        fig = plot_2d(trainer, [0, 7, 8])
        fig.savefig("results/predictions.png")
        print("plots saved under results/")
    except Exception as e:  # pragma: no cover
        print(f"plotting skipped: {e}")

    trainer.finalize()
    return trainer


if __name__ == "__main__":
    main()
