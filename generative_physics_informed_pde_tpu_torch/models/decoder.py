"""Decoders z -> random-field reconstruction ("f").

Port of ``CNNDecoder``, ``LinearDecoder`` and ``NeuralNetworkDecoder``
from ``generative_physics_informed_pde_tpu/models/decoder.py``.  The CNN
decoder:
z --Dense--> latent image --conv3x3--> [DenseBlock -> TransitionUp]
--LastDecoding--> a 2-channel image (mean, logsigma), or one channel
(the mean alone) for a binary, homoscedastic or single-output decode.
The public layout is the JAX package's: images (B, py, px) out.  The
latent image is reshaped in Flax's (H, W, C) order so that the dense
layer's weights carry over unchanged.  Its convolutions run in
``compute_dtype`` (None: full precision; see ``codec.py``), the dense layer
at the input's precision, and the output is cast back to it.  The linear
and MLP decoders return flat (B, dim_out) outputs with a homoscedastic
``logsigma`` and have no compute dtype.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .codec import DenseBlock, LastDecoding, SameConv2d, TransitionUp
from .mlp import architecture_from_linear_decay


class CNNDecoder(nn.Module):
    """``latent_img_size * 2**len(blocks)`` must equal
    ``target_img_size``."""

    def __init__(self, target_img_size: int, dim_latent: int,
                 latent_img_size: int = 4, latent_img_features: int = 16,
                 init_features: int = 32, blocks: Sequence[int] = (3, 5, 3),
                 growth_rate: int = 8, drop_rate: float = 0.0,
                 upsample: str = "nearest", binary: bool = False,
                 homoscedastic: bool = False,
                 force_single_output: bool = False, compute_dtype=None,
                 pad_cin: int = 0):
        super().__init__()
        out_img = latent_img_size * 2 ** len(blocks)
        if out_img != target_img_size:
            raise ValueError(
                f"latent image {latent_img_size} with {len(blocks)} blocks "
                f"yields {out_img}, target is {target_img_size}")
        self.target_img_size = target_img_size
        self.blocks = tuple(blocks)
        self.growth_rate = growth_rate
        self.init_features = init_features
        self.compute_dtype = compute_dtype
        # zero input channels add nothing to a conv: the JAX package pads
        # for the TPU's 128-lane tiling, the port runs the unpadded convs
        self.pad_cin = pad_cin
        self.dim_latent = dim_latent
        self.latent_img_size = latent_img_size
        self.latent_img_features = latent_img_features
        self.binary = binary
        self.homoscedastic = homoscedastic
        self.force_single_output = force_single_output
        s = latent_img_size
        self.Dense_0 = nn.Linear(dim_latent, s * s * latent_img_features)
        self.Conv_0 = SameConv2d(latent_img_features, init_features, 3)
        nf = init_features
        for i, nl in enumerate(blocks):
            self.add_module(f"DenseBlock_{i}", DenseBlock(
                nf, nl, growth_rate, drop_rate=drop_rate))
            nf += nl * growth_rate
            if i < len(blocks) - 1:
                self.add_module(f"TransitionUp_{i}", TransitionUp(
                    nf, nf // 2, drop_rate, upsample))
                nf //= 2
        self.n_blocks = len(blocks)
        self.LastDecoding_0 = LastDecoding(nf, self.out_channels, drop_rate,
                                           upsample=upsample)
        if homoscedastic:
            self.logsigma = nn.Parameter(torch.zeros(target_img_size,
                                                     target_img_size))

    @property
    def out_channels(self) -> int:
        return 1 if (self.binary or self.force_single_output
                     or self.homoscedastic) else 2

    @property
    def dim_in(self) -> int:
        return self.dim_latent

    @property
    def dim_out(self) -> int:
        return self.target_img_size ** 2

    def forward(self, z, generator=None, compute_dtype=None):
        """z (B, dim_latent) -> (mean, logsigma), each (B, py, px); the
        mean alone for binary or single-output decodes.  In train mode the
        dropout masks come from ``generator``.  ``compute_dtype``
        overrides the module's own for this call."""
        cd = compute_dtype or self.compute_dtype
        b, s = z.shape[0], self.latent_img_size
        x = self.Dense_0(z).reshape(b, s, s, self.latent_img_features)
        in_dtype = x.dtype
        x = x.permute(0, 3, 1, 2)  # Flax HWC -> NCHW
        if cd is not None:
            x = x.to(cd)
        x = self.Conv_0(x, cd)
        for i in range(self.n_blocks):
            x = getattr(self, f"DenseBlock_{i}")(x, generator, cd)
            if i < self.n_blocks - 1:
                x = getattr(self, f"TransitionUp_{i}")(x, generator, cd)
        x = self.LastDecoding_0(x, generator, cd).to(in_dtype)
        if self.binary:
            return torch.sigmoid(x[:, 0])
        mean = x[:, 0]
        if self.force_single_output:
            return mean
        if self.homoscedastic:
            return mean, self.logsigma.to(mean.dtype).expand_as(mean)
        return mean, x[:, 1]


class LinearDecoder(nn.Module):
    """Affine decoder with a homoscedastic logsigma; a sigmoid mean alone
    when ``binary``."""

    def __init__(self, dim_latent: int, dim_out: int, binary: bool = False):
        super().__init__()
        self.dim_latent, self.dim_out, self.binary = dim_latent, dim_out, \
            binary
        self.Dense_0 = nn.Linear(dim_latent, dim_out)
        if not binary:
            self.logsigma = nn.Parameter(torch.zeros(dim_out))

    @property
    def dim_in(self) -> int:
        return self.dim_latent

    def forward(self, z, generator=None):
        mean = self.Dense_0(z)
        if self.binary:
            return torch.sigmoid(mean)
        return mean, self.logsigma.expand_as(mean)


class NeuralNetworkDecoder(LinearDecoder):
    """MLP decoder: ReLU hidden layers of linear-decay widths, then the
    affine output and the homoscedastic logsigma."""

    def __init__(self, dim_latent: int, dim_out: int,
                 num_hidden_layers: int = 1, binary: bool = False):
        widths = architecture_from_linear_decay(dim_latent, dim_out,
                                                num_hidden_layers)
        nn.Module.__init__(self)
        self.dim_latent, self.dim_out, self.binary = dim_latent, dim_out, \
            binary
        n_in = dim_latent
        for i, w in enumerate(widths + [dim_out]):
            self.add_module(f"Dense_{i}", nn.Linear(n_in, w))
            n_in = w
        self.n_dense = len(widths) + 1
        if not binary:
            self.logsigma = nn.Parameter(torch.zeros(dim_out))

    def forward(self, z, generator=None):
        x = z
        for i in range(self.n_dense - 1):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
        mean = getattr(self, f"Dense_{self.n_dense - 1}")(x)
        if self.binary:
            return torch.sigmoid(mean)
        return mean, self.logsigma.expand_as(mean)
