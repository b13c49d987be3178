"""The semi-supervised physics-informed VAE and its composite ELBO.

Port of ``GenerativeModel`` and ``DiscriminativeModel`` from
``generative_physics_informed_pde_tpu/models/generative.py``.  The JAX
package's parameter pytree becomes the module tree: the decoder ``f``, the
amortized ``encoder``, the property map ``gp``, the ROM operator ``g`` and
the per-datapoint posteriors ``q_z`` / ``q_X`` (``nn.ParameterDict``s
holding ``mean`` and ``logsigma``), all optimised by one Adam; the
BatchNorm statistics are the modules' buffers, updated in place by every
train-mode decode in the order the reference chains them.

Ported: ``elbo_supervised``, ``elbo_unsupervised_amortized`` and ``elbo``
with one Monte-Carlo sample, unfused decodes and the L2 penalty.  Not
ported yet: the non-amortized unsupervised term, the virtual-observable
term and its moment propagation, fused decodes and ``n_mc > 1``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..inference import variational as va
from ..inference.likelihoods import (bernoulli_log_likelihood,
                                     diagonal_gaussian_log_likelihood,
                                     reparametrize, unit_gaussian_kld)
from .components import EffectivePropertyMap, ReducedOrderModelOperator


class GenerativeModel(nn.Module):
    """Decoder f, ROM operator g, property map gp, optional amortized
    encoder, and the per-datapoint posteriors created by
    :meth:`init_params`."""

    def __init__(self, g: ReducedOrderModelOperator,
                 gp: EffectivePropertyMap,
                 encoder: Optional[nn.Module] = None,
                 f: Optional[nn.Module] = None, *,
                 independent_X: bool = True, binary_field: bool = False,
                 reconstruct_log_eff_property: bool = True):
        super().__init__()
        self.f = f
        self.g = g
        self.gp = gp
        self.encoder = encoder
        self.q_z = nn.ModuleDict()
        self.q_X = nn.ModuleDict()
        self.independent_X = independent_X
        self.binary_field = binary_field
        self.reconstruct_log_eff_property = reconstruct_log_eff_property
        self.disable_elbo_supervised = False
        self.disable_elbo_unsupervised = False

    # ------------------------------------------------------------- shapes
    @property
    def dim_latent(self) -> int:
        return self.f.dim_latent

    @property
    def dim_effective_property(self) -> int:
        return self.g.dim_effective_property

    @property
    def dim_y(self) -> int:
        return self.g.dim_out

    # ------------------------------------------------------- param init
    def init_params(self, datasets: Dict[str, dict]) -> "GenerativeModel":
        """Create the per-datapoint posteriors (zero mean and logsigma) in
        the model's dtype on its device: ``q_z`` for the labeled (and, when
        not amortized, unlabeled) data, ``q_X`` for the labeled data when
        ``independent_X``.  ``datasets`` maps modality -> dict with 'X'."""
        ref = next(self.gp.parameters())
        for name, data in datasets.items():
            if data is None:
                continue
            N = data["X"].shape[0]
            if name == "unsupervised" and self.encoder is not None:
                continue  # amortized: no per-datapoint q_z
            if name in ("supervised", "unsupervised"):
                self.q_z[name] = va.init_variational(
                    N, self.dim_latent, dtype=ref.dtype, device=ref.device)
            if self.independent_X and name == "supervised":
                self.q_X[name] = va.init_variational(
                    N, self.dim_effective_property, dtype=ref.dtype,
                    device=ref.device)
        return self

    # ------------------------------------------------------- applications
    def apply_decoder(self, z, *, train: bool, generator=None):
        """Decode in train mode (batch statistics, running-stat update,
        dropout masks from ``generator``) or eval mode (running
        statistics, no dropout)."""
        self.f.train(train)
        return self.f(z, generator)

    def apply_encoder(self, x, *, train: bool = False, generator=None):
        self.encoder.train(train)
        return self.encoder(x, generator)

    def apply_gp(self, z):
        return self.gp(z)

    def apply_g(self, effprop, F_):
        return self.g(effprop, F_)

    # ---------------------------------------------------- likelihood of x
    def random_field_likelihood(self, predict, target):
        """Gaussian on the log field (or the exp field), or Bernoulli."""
        if self.binary_field:
            return bernoulli_log_likelihood(predict, target)
        mean, logsigma = predict
        if self.reconstruct_log_eff_property:
            return diagonal_gaussian_log_likelihood(target, mean,
                                                    2 * logsigma)
        return diagonal_gaussian_log_likelihood(
            torch.exp(target), torch.exp(mean), 2 * logsigma)

    # ------------------------------------------------------- ELBO pieces
    def elbo_supervised(self, data, generator=None, *, train: bool = True,
                        normalize: bool = False):
        """Labeled-pair term -> (elbo, logs)."""
        if self.disable_elbo_supervised:
            return 0.0, {}
        X, Y, F_ = data["X"], data["Y"], data["F_ROM_BC"]
        qz = self.q_z["supervised"]
        Z = va.sample(qz, generator)
        predict_x = self.apply_decoder(Z, train=train, generator=generator)
        logL_x = self.random_field_likelihood(predict_x, X)
        DKL = va.kld(qz)
        if self.independent_X:
            qX = self.q_X["supervised"]
            X_sample = va.sample(qX, generator)
            mu_X, logsigmas_X = self.apply_gp(Z)
            logL_X = diagonal_gaussian_log_likelihood(X_sample, mu_X,
                                                      2 * logsigmas_X)
            ent = va.entropy(qX)
        else:
            X_sample = self.apply_gp(Z)
            logL_X = 0.0
            ent = 0.0
        mu_y, logsigmas_y = self.apply_g(X_sample, F_)
        logL_y = diagonal_gaussian_log_likelihood(Y, mu_y, 2 * logsigmas_y)
        if normalize:
            bs = X.shape[0]
            logL_x, logL_y, logL_X, ent, DKL = (
                v / bs for v in (logL_x, logL_y, logL_X, ent, DKL))
        elbo = logL_x + logL_y + logL_X + ent - DKL
        logs = {"supervised_logL_x": logL_x, "supervised_logL_y": logL_y,
                "supervised_DKL_z": DKL, "supervised_elbo": elbo}
        if self.independent_X:
            logs.update({"supervised_logL_X": logL_X,
                         "supervised_entropy_X": ent})
        return elbo, logs

    def elbo_unsupervised_amortized(self, X_batch, generator=None, *,
                                    train: bool = True,
                                    normalize: bool = False):
        """Amortized unlabeled term on a minibatch -> (elbo, logs)."""
        if self.disable_elbo_unsupervised:
            return 0.0, {}
        mean, logsigma = self.apply_encoder(X_batch, train=train,
                                            generator=generator)
        Z = reparametrize(generator, mean, logsigma)
        predict_x = self.apply_decoder(Z, train=train, generator=generator)
        logL_x = self.random_field_likelihood(predict_x, X_batch)
        DKL = unit_gaussian_kld(mean, 2 * logsigma)
        if normalize:
            bs = X_batch.shape[0]
            logL_x, DKL = logL_x / bs, DKL / bs
        elbo = logL_x - DKL
        return elbo, {"ARM_unsupervised_logL_x": logL_x,
                      "ARM_unsupervised_DKL_z": DKL,
                      "ARM_unsupervised_elbo": elbo}

    # --------------------------------------------------------- full ELBO
    def elbo(self, data, generator=None, *, train: bool = True,
             normalize: bool = False, l2_penalty: Optional[float] = None):
        """Composite ELBO -> (elbo, logs).  ``data`` maps modality ->
        tensors; 'unsupervised' is already the minibatch.  The unlabeled
        term runs first, so its decode updates the BatchNorm statistics
        before the labeled one's, as in the reference."""
        total = 0.0
        logs = {}
        if data.get("unsupervised") is not None:
            if self.encoder is None:
                raise NotImplementedError(
                    "the non-amortized unsupervised term is not ported yet")
            e, lg = self.elbo_unsupervised_amortized(
                data["unsupervised"]["X"], generator, train=train,
                normalize=normalize)
            total += e
            logs.update(lg)
        if data.get("supervised") is not None:
            e, lg = self.elbo_supervised(data["supervised"], generator,
                                         train=train, normalize=normalize)
            total += e
            logs.update(lg)
        if l2_penalty is not None:
            pen = _l2_norm_sum(self.f)
            if self.encoder is not None:
                pen = pen + _l2_norm_sum(self.encoder)
            total = total - l2_penalty * pen
            logs["elbo_l2_penalty"] = pen
        logs["elbo"] = total
        return total, logs


def _l2_norm_sum(module: nn.Module) -> torch.Tensor:
    """Sum of per-parameter L2 norms, with the gradient 0 (not NaN) at an
    all-zero parameter, as the reference defines it."""
    total = 0.0
    for p in module.parameters():
        sq = torch.sum(torch.square(p))
        safe = torch.where(sq > 0, sq, torch.ones_like(sq))
        total = total + torch.where(sq > 0, torch.sqrt(safe),
                                    torch.zeros_like(sq))
    return total


class DiscriminativeModel(nn.Module):
    """Deterministic x -> y surrogate extracted from a generative model:
    ``y = g(gp_mean(encoder_mean(x)), F)``."""

    def __init__(self, model: GenerativeModel):
        super().__init__()
        self.model = model

    @torch.no_grad()
    def forward(self, x, F_, *, use_encoder: bool = True):
        if use_encoder:
            if self.model.encoder is None:
                raise RuntimeError("encoder is not set")
            z, _ = self.model.apply_encoder(x, train=False)
        else:
            z = x  # x is already a latent encoding
        gp_out = self.model.apply_gp(z)
        X_c = gp_out[0] if isinstance(gp_out, tuple) else gp_out
        mu_y, _ = self.model.apply_g(X_c, F_)
        return mu_y
