"""Non-amortized per-datapoint Gaussian variational approximations.

Port of ``generative_physics_informed_pde_tpu/inference/variational.py``.
A posterior is a mapping with ``"mean"`` and ``"logsigma"`` tensors of
shape (N, dim): an ``nn.ParameterDict`` where it is optimised (the model's
``q_z``/``q_X``, the prediction ensemble's ``q``), a plain dict elsewhere.
Draws come from an explicit ``torch.Generator``.  The ``*_rows`` draws
serve a posterior that holds this process's rows of a sharded batch
(``parallel.layout.RowSplit``): the normals are drawn for the whole batch
and the process keeps its rows, so that the draw and the generator's
state equal the unsharded draw's on every process.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .likelihoods import standard_normal, unit_gaussian_kld


def init_variational(N: int, dim: int, dtype=torch.float32,
                     init_logsigma: float = 0.0,
                     device=None) -> nn.ParameterDict:
    """Zero mean, constant logsigma (the reference inits both to zero)."""
    return nn.ParameterDict({
        "mean": nn.Parameter(torch.zeros((N, dim), dtype=dtype,
                                         device=device)),
        "logsigma": nn.Parameter(torch.full((N, dim), init_logsigma,
                                            dtype=dtype, device=device)),
    })


def sample(params, generator=None) -> torch.Tensor:
    """One reparameterised sample per datapoint, (N, dim)."""
    eps = standard_normal(params["logsigma"].shape, params["mean"],
                          generator)
    return params["mean"] + torch.exp(params["logsigma"]) * eps


def sample_rows(params, generator, split) -> torch.Tensor:
    """:func:`sample` of a block of rows ``split`` of the whole batch."""
    shape = (split.n,) + tuple(params["logsigma"].shape[1:])
    eps = split.take(standard_normal(shape, params["mean"], generator))
    return params["mean"] + torch.exp(params["logsigma"]) * eps


def sample_component(params, index: int, generator,
                     batch_size: int) -> torch.Tensor:
    """(batch_size, dim) samples of datapoint ``index``."""
    mean = params["mean"][index]
    logsigma = params["logsigma"][index]
    eps = standard_normal((batch_size,) + tuple(mean.shape), mean, generator)
    return mean + torch.exp(logsigma) * eps


def sample_all_components(params, generator,
                          batch_size: int) -> torch.Tensor:
    """(N, batch_size, dim) Monte-Carlo samples of every datapoint."""
    mean = params["mean"][:, None, :]
    logsigma = params["logsigma"][:, None, :]
    eps = standard_normal((mean.shape[0], batch_size, mean.shape[-1]),
                          params["mean"], generator)
    return mean + torch.exp(logsigma) * eps


def sample_all_components_rows(params, generator, batch_size: int,
                               split=None) -> torch.Tensor:
    """:func:`sample_all_components` of a block of rows ``split`` of the
    whole batch (None: all of it, :func:`sample_all_components` itself)."""
    if split is None:
        return sample_all_components(params, generator, batch_size)
    mean = params["mean"][:, None, :]
    logsigma = params["logsigma"][:, None, :]
    eps = split.take(standard_normal((split.n, batch_size, mean.shape[-1]),
                                     params["mean"], generator))
    return mean + torch.exp(logsigma) * eps


def kld(params) -> torch.Tensor:
    """Unit-Gaussian KL, summed."""
    return unit_gaussian_kld(params["mean"], 2.0 * params["logsigma"])


def entropy(params) -> torch.Tensor:
    """Gaussian entropy summed over datapoints and dims (with the
    constant N*dim*(log 2pi + 1)/2, as the JAX package corrects it)."""
    N, dim = params["mean"].shape
    const = N * dim * 0.5 * (np.log(2 * np.pi) + 1.0)
    return torch.sum(params["logsigma"]) + const


def init_by_encoder(apply_encoder, X) -> dict:
    """(mean, logsigma) from an amortized encoder."""
    mu, logsigma = apply_encoder(X)
    return {"mean": mu, "logsigma": logsigma}
