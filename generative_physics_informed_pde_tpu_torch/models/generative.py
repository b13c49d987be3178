"""The pieces of the generative model that the extracted surrogate needs.

Port of ``GenerativeModel.apply_encoder`` / ``apply_gp`` / ``apply_g`` and
``DiscriminativeModel.__call__`` from
``generative_physics_informed_pde_tpu/models/generative.py``, inference
mode only.  The decoder, the variational posteriors and the ELBO wait for
the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .components import EffectivePropertyMap, ReducedOrderModelOperator


class GenerativeModel(nn.Module):
    """Holds the amortized encoder, the property map gp and the ROM
    operator g (the decoder f is not ported yet)."""

    def __init__(self, g: ReducedOrderModelOperator,
                 gp: EffectivePropertyMap,
                 encoder: Optional[nn.Module] = None):
        super().__init__()
        self.g = g
        self.gp = gp
        self.encoder = encoder

    def apply_encoder(self, x):
        return self.encoder(x)

    def apply_gp(self, z):
        return self.gp(z)

    def apply_g(self, effprop, F_):
        return self.g(effprop, F_)


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
            z, _ = self.model.apply_encoder(x)
        else:
            z = x  # x is already a latent encoding
        gp_out = self.model.apply_gp(z)
        X_c = gp_out[0] if isinstance(gp_out, tuple) else gp_out
        mu_y, _ = self.model.apply_g(X_c, F_)
        return mu_y
