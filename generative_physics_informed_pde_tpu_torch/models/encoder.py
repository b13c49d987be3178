"""DenseNet conv encoder x -> (mu_z, logsigma_z).

Port of ``CNNEncoder`` and ``SplitHeads`` from
``generative_physics_informed_pde_tpu/models/encoder.py``.  The public
layout is the JAX package's: images (B, H, W) in.  Inside, the trunk runs
NCHW, and the trunk output is flattened in Flax's (H, W, C) order so that
the dense layer's weights carry over unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from .codec import DenseBlock, SameConv2d, TransitionDown


class SplitHeads(nn.Module):
    """Twin linear heads (mean, logsigma)."""

    def __init__(self, in_features: int, latent_dim: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, latent_dim)
        self.Dense_1 = nn.Linear(in_features, latent_dim)

    def forward(self, x):
        return self.Dense_0(x), self.Dense_1(x)


class CNNEncoder(nn.Module):
    """In_conv k7s2 -> [DenseBlock -> TransitionDown] x len(blocks)
    (bottleneck design, bn_size=8) -> flatten -> FC(relu) -> split heads.
    ``imsize`` must be divisible by ``2**(len(blocks)+1)``."""

    def __init__(self, imsize: int, latent_dim: int,
                 blocks: Sequence[int] = (3, 5, 3), growth_rate: int = 8,
                 init_features: int = 32, drop_rate: float = 0.0):
        super().__init__()
        self.imsize = imsize
        self.latent_dim = latent_dim
        self.Conv_0 = SameConv2d(1, init_features, 7, stride=2)
        nf = init_features
        for i, nl in enumerate(blocks):
            self.add_module(f"DenseBlock_{i}", DenseBlock(
                nf, nl, growth_rate, bn_size=8, bottleneck=True,
                drop_rate=drop_rate))
            nf += nl * growth_rate
            self.add_module(f"TransitionDown_{i}",
                            TransitionDown(nf, nf // 2,
                                           drop_rate=drop_rate))
            nf //= 2
        self.n_blocks = len(blocks)
        self.imsize_out = imsize // (2 ** (len(blocks) + 1))
        width = nf * self.imsize_out ** 2
        self.Dense_0 = nn.Linear(width, width)
        self.SplitHeads_0 = SplitHeads(width, latent_dim)

    @property
    def dim_in(self) -> int:
        return self.imsize ** 2

    def forward(self, x, generator=None):
        """x (B, H, W) -> (mean, logsigma), each (B, latent_dim).  In train
        mode the dropout masks come from ``generator``."""
        x = self.Conv_0(x[:, None])
        for i in range(self.n_blocks):
            x = getattr(self, f"DenseBlock_{i}")(x, generator)
            x = getattr(self, f"TransitionDown_{i}")(x, generator)
        if x.shape[-2:] != (self.imsize_out, self.imsize_out):
            raise ValueError(f"encoder trunk produced {tuple(x.shape)}, "
                             f"expected {self.imsize_out}^2")
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # Flax HWC order
        x = F.relu(self.Dense_0(x))
        return self.SplitHeads_0(x)
