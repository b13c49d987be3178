"""Posterior-predictive evaluation (metrics over a dataset).

Port of ``Analysis`` / ``DataPair`` from
``generative_physics_informed_pde_tpu/inference/analysis.py``: the whole
Monte-Carlo sample -> propagate -> metric pipeline runs batched over the
dataset.  Above an element budget the Monte-Carlo axis streams in equal
chunks (``_mc_chunk``), as the reference's does: the working set stays
bounded at 256^2 and 512^2, and the sample count is rounded up to fill the
chunks, so the metrics average over the reference's number of samples.

In sharded training an analysis holds this process's rows of its dataset
and of the posterior it is given (``split``, a
``parallel.layout.RowSplit``), as the JAX package's row-sharded analyses
compute: every draw is made for the whole dataset and cut, the chunk plan
is the whole dataset's, and the sums behind rel-L2, R^2 and the logscore
run over the processes, so every process records the one-process values.
"""

from __future__ import annotations

import math
from math import prod
from typing import Dict, Optional

import torch

from ..models import components
from ..parallel.layout import RowSplit
from . import variational as va
from .likelihoods import predictive_logscore, relative_error, standard_normal


# Largest Monte-Carlo block, in elements of the N x S_chunk x dim working
# set, that one evaluation materialises; above it the samples stream in
# chunks with first- and second-moment sums.  Read at call time (tests
# patch it); the x evaluation's budget is 8 times tighter (the decoder's
# intermediates run ~8x its output pixels).
_EVAL_ELEMENT_BUDGET = 2 ** 27


def _mc_chunk(n_monte_carlo: int, per_mc_elements: int,
              budget: Optional[int] = None):
    """(chunk, n_chunks): ``n_monte_carlo`` split into equal chunks whose
    ``chunk * per_mc_elements`` stays under ``budget`` (default the module
    budget); ``chunk * n_chunks >= n_monte_carlo``, the effective sample
    count rounded up, never down."""
    if budget is None:
        budget = _EVAL_ELEMENT_BUDGET
    chunk = max(1, min(n_monte_carlo, budget // max(per_mc_elements, 1)))
    return chunk, math.ceil(n_monte_carlo / chunk)


def _moments(draw, n_monte_carlo: int, per_mc_elements: int, budget: int):
    """(mean, std, (chunk, n_chunks)) over the sample axis 1 of
    ``draw(S)``'s (N, S, dim) samples: one draw of all samples (std
    floored at 1e-6), or ``n_chunks`` draws of ``chunk`` in call order
    whose sums give E[y] and E[y^2] - E[y]^2 over ``chunk * n_chunks``
    samples (variance floored at 1e-12, the same floor)."""
    chunk, n_chunks = _mc_chunk(n_monte_carlo, per_mc_elements, budget)
    if n_chunks == 1:
        S = draw(n_monte_carlo)
        return (S.mean(dim=1),
                torch.clamp(S.std(dim=1, correction=1), min=1e-6),
                (chunk, n_chunks))
    s1 = s2 = 0.0
    for _ in range(n_chunks):
        S = draw(chunk)
        s1 = s1 + S.sum(dim=1)
        s2 = s2 + S.square().sum(dim=1)
        del S
    S_eff = chunk * n_chunks
    mean = s1 / S_eff
    var = torch.clamp((s2 - S_eff * mean.square()) / (S_eff - 1), min=1e-12)
    return mean, var.sqrt(), (chunk, n_chunks)


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

    def min(self):
        return min(self.value)

    def max(self):
        return max(self.value)

    def final(self):
        return self.value[-1]


def _normals(shape, like, generator, split=None):
    """Standard normals of ``shape`` (rows first); with ``split`` (this
    process's rows of a sharded batch), drawn for all ``split.n`` rows and
    the split's rows kept."""
    split = split or RowSplit.whole(shape[0])
    return split.take(standard_normal((split.n,) + tuple(shape[1:]), like,
                                      generator))


def _dataset_sums(split, *per_row):
    """Each (rows, ...) tensor of ``per_row`` summed over the rows of the
    dataset: over the rows it holds, then, with ``split`` (sharded: they
    are this process's), over the processes, in one reduction."""
    sums = [v.sum(0) for v in per_row]
    if split is None:
        return sums
    total = split.sum(torch.cat([v.reshape(-1) for v in sums]))
    return [t.view_as(v) for t, v in
            zip(total.split([v.numel() for v in sums]), sums)]


def y_metrics(y_mean, y_std, Y, split=None) -> dict:
    """relerr_y (mean per-row relative L2), r2_y, logscore_y; ``split``:
    the rows are this process's of a sharded dataset, whose metrics every
    process gets (R^2 takes the whole dataset's mean of Y: two sums over
    the processes)."""
    Y = Y.to(y_mean.dtype)
    n = Y.shape[0] if split is None else split.n
    relerr, logscore, Y_sum, ss_res = _dataset_sums(
        split, relative_error(y_mean, Y),
        predictive_logscore(Y, y_mean, y_std), Y, (Y - y_mean) ** 2)
    (ss_tot,) = _dataset_sums(split, (Y - Y_sum / n) ** 2)
    return {"relerr_y": relerr / n, "r2_y": torch.mean(1.0 - ss_res / ss_tot),
            "logscore_y": logscore / n, "y_mean": y_mean, "y_std": y_std}


def x_metrics(x_mean, x_std, X, split=None) -> dict:
    """relerr_x and logscore_x of flattened field reconstructions;
    ``split`` as :func:`y_metrics`'s."""
    X = X.reshape(X.shape[0], -1).to(x_mean.dtype)
    n = X.shape[0] if split is None else split.n
    relerr, logscore = _dataset_sums(split, relative_error(x_mean, X),
                                     predictive_logscore(X, x_mean, x_std))
    return {"relerr_x": relerr / n, "logscore_x": logscore / n}


class Analysis:
    """Posterior-predictive y (and x) metrics for one dataset: ``model``
    the GenerativeModel, ``data`` holds 'X', 'Y', 'F_ROM_BC'."""

    def __init__(self, model, data: Dict[str, torch.Tensor],
                 label: str = "validation", writer=None, split=None):
        self.model = model
        self.data = data
        # sharded: ``data`` and the posteriors given hold these rows
        self.split = split
        self.label = label
        self.writer = writer
        self.series = {
            name: DataPair(writer, label, name)
            for name in ("relerr_x", "relerr_y", "logscore_x", "logscore_y",
                         "r2_y")}
        # ("y" or "x", n_monte_carlo) -> (chunk, n_chunks) of the last
        # evaluation: its metrics averaged chunk * n_chunks samples
        self.mc_chunks = {}

    @property
    def n(self) -> int:
        """The rows of the dataset (of which ``data`` may hold this
        process's)."""
        return self.data["X"].shape[0] if self.split is None \
            else self.split.n

    @classmethod
    def from_encoder(cls, model, data: Dict[str, torch.Tensor], **kw):
        """Amortized-posterior analysis: ``q = encoder(X)`` in eval mode,
        the weights frozen.  -> (analysis, q)."""
        with torch.no_grad():
            mean, logsigma = model.apply_encoder(data["X"], train=False)
        return cls(model, data, **kw), {"mean": mean, "logsigma": logsigma}

    @torch.no_grad()
    def sample_predictive_y(self, q, generator, n_monte_carlo: int,
                            index: Optional[int] = None, F=None):
        """(N, S, dim_y) samples: z ~ q -> gp -> g, each reparametrised;
        with ``index`` the (S, dim_y) samples of that datapoint alone.
        ``F``: the ROM forces (N, d_rom), default the instance data's.
        With a ``split`` the rows of ``q`` and ``F`` are this process's
        and the draws are made for the whole dataset and cut."""
        F_ = self.data["F_ROM_BC"] if F is None else F
        if index is not None:
            Zs = va.sample_component(q, index, generator, n_monte_carlo)
            Xs = components.propagate_gp_samples(self.model.apply_gp(Zs),
                                                 generator)
            mean, logsigmas = self.model.apply_g(
                Xs, F_[index][None, :].expand(n_monte_carlo, F_.shape[-1]))
            eps = standard_normal(mean.shape, mean, generator)
            return mean + torch.exp(logsigmas) * eps
        split = self.split
        mc = split and split.repeat(n_monte_carlo)  # None: all rows
        Zs = va.sample_all_components_rows(q, generator, n_monte_carlo,
                                           split)
        N = Zs.shape[0]
        gp_out = self.model.apply_gp(Zs.reshape(-1, Zs.shape[-1]))
        Xs = components.propagate_gp_samples(gp_out, generator, split=mc)
        F_rep = F_[:, None, :].expand(N, n_monte_carlo, F_.shape[-1])
        mean, logsigmas = self.model.apply_g(
            Xs, F_rep.reshape(N * n_monte_carlo, -1))
        eps = _normals(mean.shape, mean, generator, mc)
        return (mean + torch.exp(logsigmas) * eps).reshape(
            N, n_monte_carlo, -1)

    @torch.no_grad()
    def sample_predictive_x(self, q, generator, n_monte_carlo: int,
                            index: int):
        """(S, py, px) reconstruction samples of datapoint ``index``:
        eval-mode decodes of q's samples plus the decoder's noise."""
        Zs = va.sample_component(q, index, generator, n_monte_carlo)
        mean, logsigma = self.model.apply_decoder(Zs, train=False)
        eps = standard_normal(mean.shape, mean, generator)
        return mean + torch.exp(logsigma) * eps

    @torch.no_grad()
    def eval_all_y(self, q, generator, n_monte_carlo: int,
                   iteration: Optional[int] = None,
                   return_mean_std: bool = False):
        """Record the y metrics at ``iteration`` (and with
        ``return_mean_std`` return the predictive (y_mean, y_std)), or
        without one return (logscore_y, r2_y, relerr_y)."""
        if iteration is None and return_mean_std:
            raise ValueError("return_mean_std needs an iteration")
        Y = self.data["Y"]
        y_mean, y_std, self.mc_chunks["y", n_monte_carlo] = _moments(
            lambda S: self.sample_predictive_y(q, generator, S),
            n_monte_carlo, self.n * Y.shape[-1], _EVAL_ELEMENT_BUDGET)
        out = y_metrics(y_mean, y_std, Y, self.split)
        if iteration is None:
            return (float(out["logscore_y"]), float(out["r2_y"]),
                    float(out["relerr_y"]))
        for k in ("relerr_y", "logscore_y", "r2_y"):
            self.series[k].append(iteration, out[k])
        return (y_mean, y_std) if return_mean_std else None

    @torch.no_grad()
    def eval_all_x(self, q, generator, n_monte_carlo: int,
                   iteration: Optional[int] = None) -> dict:
        """x metrics of eval-mode decodes of q's samples (with a
        ``split``, of this process's rows, reduced as the y metrics)."""
        X = self.data["X"]
        N, dim_x = X.shape[0], prod(X.shape[1:])
        split = self.split

        def draw(S):
            Zs = va.sample_all_components_rows(q, generator, S, split)
            mean, logsigma = self.model.apply_decoder(
                Zs.reshape(N * S, -1), train=False)
            eps = _normals(mean.shape, mean, generator,
                           split and split.repeat(S))
            return (mean + torch.exp(logsigma) * eps).reshape(N, S, dim_x)

        x_mean, x_std, self.mc_chunks["x", n_monte_carlo] = _moments(
            draw, n_monte_carlo, self.n * dim_x, _EVAL_ELEMENT_BUDGET // 8)
        out = x_metrics(x_mean, x_std, X, split)
        if iteration is not None:
            for k in ("relerr_x", "logscore_x"):
                self.series[k].append(iteration, out[k])
        return {k: float(v) for k, v in out.items()}

    def eval_all(self, q, generator, n_monte_carlo: int,
                 iteration: Optional[int] = None) -> dict:
        """The y metrics, then the x metrics (both recorded at
        ``iteration``); -> the x scalars, and without an iteration, which
        leaves no series to read them from, the y scalars too."""
        y = self.eval_all_y(q, generator, n_monte_carlo,
                            iteration=iteration)
        res = self.eval_all_x(q, generator, n_monte_carlo,
                              iteration=iteration)
        if iteration is None:
            res["logscore_y"], res["r2_y"], res["relerr_y"] = y
        return res
