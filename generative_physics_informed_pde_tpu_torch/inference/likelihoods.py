"""ELBO math primitives.

Port of ``generative_physics_informed_pde_tpu/inference/likelihoods.py``:
the reparametrised draw, Gaussian log-likelihood and unit-Gaussian KL
(summed over all elements, the reference's ELBO scaling), the Bernoulli
likelihood, relative errors, R^2 and the predictive logscore.  Draws come
from an explicit ``torch.Generator``, on the generator's device.
"""

from __future__ import annotations

from typing import Optional

import torch

LOG_2PI = 1.8378770664093453  # the reference hard-codes this constant


def standard_normal(shape, like: torch.Tensor,
                    generator: Optional[torch.Generator] = None):
    """Standard normals of ``shape`` in ``like``'s dtype on ``like``'s
    device, drawn from ``generator`` on its own device."""
    device = generator.device if generator is not None else like.device
    eps = torch.randn(tuple(shape), generator=generator, dtype=like.dtype,
                      device=device)
    return eps.to(like.device)


def reparametrize(generator, mean, logsigma):
    """mean + exp(logsigma) * eps."""
    return mean + torch.exp(logsigma) * standard_normal(logsigma.shape,
                                                        mean, generator)


def reparametrize_rows(generator, mean, logsigma, split):
    """:func:`reparametrize` of this process's rows ``split`` (a
    ``parallel.layout.RowSplit``) of a sharded batch: the normals drawn
    for the whole batch, this process's rows kept."""
    shape = (split.n,) + tuple(logsigma.shape[1:])
    return mean + torch.exp(logsigma) * split.take(
        standard_normal(shape, mean, generator))


def diagonal_gaussian_log_likelihood(target, mean, logvars, reduce=torch.sum):
    """Sum of elementwise Gaussian log-densities; ``logvars = 2 logsigma``."""
    part2 = (target - mean) ** 2 * torch.exp(-logvars)
    L = -0.5 * (logvars + part2 + LOG_2PI)
    return reduce(L) if reduce is not None else L


def unit_gaussian_kld(mean, logvars):
    """KL(N(mean, exp(logvars)) || N(0, I)) summed over everything."""
    return -0.5 * torch.sum(1 + logvars - mean ** 2 - torch.exp(logvars))


def bernoulli_log_likelihood(predict, target):
    """Binary-field path: -BCE(sum) with targets binarised at the
    minimum."""
    t = torch.where(target == target.min(), 0.0, 1.0).to(predict.dtype)
    p = torch.clamp(predict, 1e-12, 1 - 1e-12)
    return torch.sum(t * torch.log(p) + (1 - t) * torch.log(1 - p))


def relative_error(y, y_true):
    """||y - y*|| / ||y*|| over the last axis (batched over the rest)."""
    return torch.linalg.vector_norm(y - y_true, dim=-1) / \
        torch.linalg.vector_norm(y_true, dim=-1)


def relative_error_batched(Y, Y_true):
    """Mean over the batch of per-row relative L2 errors."""
    num = torch.sqrt(torch.sum((Y - Y_true) ** 2, dim=1))
    den = torch.sqrt(torch.sum(Y_true ** 2, dim=1))
    return torch.mean(num / den)


def coefficient_of_determination(y_pred, y, global_average: bool = False):
    """R^2; per-dimension mean by default."""
    y_pred = y_pred.reshape(y_pred.shape[0], -1)
    y = y.reshape(y.shape[0], -1)
    if global_average:
        e = torch.sum((y - y_pred) ** 2) / torch.sum((y - y.mean()) ** 2)
        return 1.0 - e
    e = torch.sum((y - y_pred) ** 2, 0) / torch.sum((y - y.mean(0)) ** 2, 0)
    return torch.mean(1.0 - e)


def predictive_logscore(y_true, y_mean, y_std):
    """Mean Gaussian predictive log-density over the last axis (batched
    over the rest)."""
    return torch.mean(-torch.log(y_std)
                      - 0.5 * (y_true - y_mean) ** 2 / y_std ** 2
                      - 0.5 * LOG_2PI, dim=-1)
