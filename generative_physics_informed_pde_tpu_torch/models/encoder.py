"""Encoders x -> (mu_z, logsigma_z).

Port of ``CNNEncoder``, ``SplitHeads``, ``LinearEncoder`` and
``NeuralNetworkEncoder`` from
``generative_physics_informed_pde_tpu/models/encoder.py``.  The public
layout is the JAX package's: images (B, H, W) in.  Inside, the CNN trunk
runs NCHW in ``compute_dtype`` (None: full precision; see ``codec.py``),
its output is cast back to the input's precision and flattened in Flax's
(H, W, C) order so that the dense layer's weights carry over unchanged;
the head runs at the input's precision.  The linear and MLP encoders
flatten the image and return a homoscedastic logsigma.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .codec import DenseBlock, SameConv2d, TransitionDown
from .mlp import architecture_from_linear_decay


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
                 init_features: int = 32, drop_rate: float = 0.0,
                 compute_dtype=None, pad_cin: int = 0):
        super().__init__()
        self.imsize = imsize
        self.latent_dim = latent_dim
        self.blocks = tuple(blocks)
        self.compute_dtype = compute_dtype
        # zero input channels add nothing to a conv: the JAX package pads
        # for the TPU's 128-lane tiling, the port runs the unpadded convs
        self.pad_cin = pad_cin
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

    def forward(self, x, generator=None, compute_dtype=None):
        """x (B, H, W) -> (mean, logsigma), each (B, latent_dim).  In train
        mode the dropout masks come from ``generator``.  ``compute_dtype``
        overrides the module's own for this call."""
        cd = compute_dtype or self.compute_dtype
        in_dtype = x.dtype
        x = x[:, None] if cd is None else x[:, None].to(cd)
        x = self.Conv_0(x, cd)
        for i in range(self.n_blocks):
            x = getattr(self, f"DenseBlock_{i}")(x, generator, cd)
            x = getattr(self, f"TransitionDown_{i}")(x, generator, cd)
        x = x.to(in_dtype)
        if x.shape[-2:] != (self.imsize_out, self.imsize_out):
            raise ValueError(f"encoder trunk produced {tuple(x.shape)}, "
                             f"expected {self.imsize_out}^2")
        x = x.permute(0, 2, 3, 1).flatten(1)  # Flax HWC order
        x = F.relu(self.Dense_0(x))
        return self.SplitHeads_0(x)


class LinearEncoder(nn.Module):
    """Affine encoder with a homoscedastic logsigma; the mean alone when
    ``binary``."""

    def __init__(self, dim_in: int, latent_dim: int, binary: bool = False):
        super().__init__()
        self.dim_in, self.latent_dim, self.binary = dim_in, latent_dim, \
            binary
        self.Dense_0 = nn.Linear(dim_in, latent_dim)
        if not binary:
            self.logsigma = nn.Parameter(torch.zeros(latent_dim))

    def _head(self, x):
        return self.Dense_0(x)

    def forward(self, x, generator=None):
        mean = self._head(x.flatten(1))
        if self.binary:
            return mean
        return mean, self.logsigma.expand_as(mean)


class NeuralNetworkEncoder(LinearEncoder):
    """MLP encoder: ReLU hidden layers of linear-decay widths, then the
    affine mean and the homoscedastic logsigma."""

    def __init__(self, dim_in: int, latent_dim: int,
                 num_hidden_layers: int = 1, binary: bool = False):
        widths = architecture_from_linear_decay(dim_in, latent_dim,
                                                num_hidden_layers)
        nn.Module.__init__(self)
        self.dim_in, self.latent_dim, self.binary = dim_in, latent_dim, \
            binary
        n_in = dim_in
        for i, w in enumerate(widths + [latent_dim]):
            self.add_module(f"Dense_{i}", nn.Linear(n_in, w))
            n_in = w
        self.n_dense = len(widths) + 1
        if not binary:
            self.logsigma = nn.Parameter(torch.zeros(latent_dim))

    def _head(self, x):
        for i in range(self.n_dense - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        return getattr(self, f"Dense_{self.n_dense - 1}")(x)
