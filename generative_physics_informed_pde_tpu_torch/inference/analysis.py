"""Posterior-predictive evaluation (metrics over a dataset).

Port of ``Analysis`` / ``DataPair`` from
``generative_physics_informed_pde_tpu/inference/analysis.py``: the whole
Monte-Carlo sample -> propagate -> metric pipeline runs batched over the
dataset.  The reference's ``_mc_chunk`` streaming of the Monte-Carlo axis
bounds a TPU's memory at 512^2 and is left out: the highres32 working set
(validation x samples x dofs) fits the card as it is.
"""

from __future__ import annotations

from math import prod
from typing import Dict, Optional

import torch

from . import variational as va
from .likelihoods import (coefficient_of_determination, predictive_logscore,
                          relative_error, standard_normal)


class DataPair:
    """(iteration, value) series, mirrored into a metrics writer."""

    def __init__(self, writer=None, label: str = "",
                 name: Optional[str] = None):
        if writer is not None and name is None:
            raise ValueError("writer requires a name")
        self.iteration = []
        self.value = []
        self._writer = writer
        self._label = label
        self._name = name

    def append(self, iteration, value):
        value = float(value)
        self.iteration.append(iteration)
        self.value.append(value)
        if self._writer is not None:
            self._writer.add_scalar(f"{self._label}/{self._name}", value,
                                    global_step=iteration)

    def final(self):
        return self.value[-1]


def propagate_gp_samples(gp_out, generator=None):
    """Reparameterised sample through the effective-property map."""
    if isinstance(gp_out, tuple):
        mean, logsigmas = gp_out
        eps = standard_normal(logsigmas.shape, mean, generator)
        return mean + torch.exp(logsigmas) * eps
    return gp_out


def y_metrics(y_mean, y_std, Y) -> dict:
    """relerr_y (mean per-row relative L2), r2_y, logscore_y."""
    Y = Y.to(y_mean.dtype)
    return {"relerr_y": relative_error(y_mean, Y).mean(),
            "r2_y": coefficient_of_determination(y_mean, Y),
            "logscore_y": predictive_logscore(Y, y_mean, y_std).mean(),
            "y_mean": y_mean, "y_std": y_std}


def x_metrics(x_mean, x_std, X) -> dict:
    """relerr_x and logscore_x of flattened field reconstructions."""
    X = X.reshape(X.shape[0], -1).to(x_mean.dtype)
    return {"relerr_x": relative_error(x_mean, X).mean(),
            "logscore_x": predictive_logscore(X, x_mean, x_std).mean()}


class Analysis:
    """Posterior-predictive y (and x) metrics for one dataset: ``model``
    the GenerativeModel, ``data`` holds 'X', 'Y', 'F_ROM_BC'."""

    def __init__(self, model, data: Dict[str, torch.Tensor],
                 label: str = "validation", writer=None):
        self.model = model
        self.data = data
        self.label = label
        self.writer = writer
        self.series = {
            name: DataPair(writer, label, name)
            for name in ("relerr_x", "relerr_y", "logscore_x", "logscore_y",
                         "r2_y")}

    @torch.no_grad()
    def sample_predictive_y(self, q, generator, n_monte_carlo: int):
        """(N, S, dim_y) samples: z ~ q -> gp -> g, each reparametrised."""
        F_ = self.data["F_ROM_BC"]
        Zs = va.sample_all_components(q, generator, n_monte_carlo)
        N = Zs.shape[0]
        gp_out = self.model.apply_gp(Zs.reshape(-1, Zs.shape[-1]))
        Xs = propagate_gp_samples(gp_out, generator)
        F_rep = F_[:, None, :].expand(N, n_monte_carlo, F_.shape[-1])
        mean, logsigmas = self.model.apply_g(
            Xs, F_rep.reshape(N * n_monte_carlo, -1))
        eps = standard_normal(mean.shape, mean, generator)
        return (mean + torch.exp(logsigmas) * eps).reshape(
            N, n_monte_carlo, -1)

    @torch.no_grad()
    def eval_all_y(self, q, generator, n_monte_carlo: int,
                   iteration: Optional[int] = None):
        """Record the y metrics at ``iteration``, or without one return
        (logscore_y, r2_y, relerr_y)."""
        Ys = self.sample_predictive_y(q, generator, n_monte_carlo)
        # variance floor: a collapsed posterior must not give -log(0)
        std = torch.clamp(Ys.std(dim=1, correction=1), min=1e-6)
        out = y_metrics(Ys.mean(dim=1), std, self.data["Y"])
        if iteration is None:
            return (float(out["logscore_y"]), float(out["r2_y"]),
                    float(out["relerr_y"]))
        for k in ("relerr_y", "logscore_y", "r2_y"):
            self.series[k].append(iteration, out[k])
        return None

    @torch.no_grad()
    def eval_all_x(self, q, generator, n_monte_carlo: int,
                   iteration: Optional[int] = None) -> dict:
        """x metrics of eval-mode decodes of q's samples."""
        X = self.data["X"]
        N = X.shape[0]
        Zs = va.sample_all_components(q, generator, n_monte_carlo)
        mean, logsigma = self.model.apply_decoder(
            Zs.reshape(N * n_monte_carlo, -1), train=False)
        eps = standard_normal(mean.shape, mean, generator)
        Xs = (mean + torch.exp(logsigma) * eps).reshape(
            N, n_monte_carlo, prod(X.shape[1:]))
        std = torch.clamp(Xs.std(dim=1, correction=1), min=1e-6)
        out = x_metrics(Xs.mean(dim=1), std, X)
        if iteration is not None:
            for k in ("relerr_x", "logscore_x"):
                self.series[k].append(iteration, out[k])
        return {k: float(v) for k, v in out.items()}
