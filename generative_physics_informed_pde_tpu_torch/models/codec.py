"""DenseNet encoder/decoder building blocks.

Port of ``generative_physics_informed_pde_tpu/models/codec.py``:
``NormReluConv``, ``DenseLayer``, ``DenseBlock``, ``TransitionDown``,
``TransitionUp``, ``LastDecoding`` and the nearest x2 upsampling.  Tensors
are NCHW inside the modules.  Submodules carry the Flax module names
(``BatchNorm_0``, ``Conv_0``, ``DenseLayer_0``, ...) so that ``convert.py``
maps a Flax parameter tree onto them path for path.

BatchNorm follows Flax: in eval mode it reads the running statistics; in
train mode (``module.train()``) it normalises with the batch mean and the
biased batch variance ``E[x^2] - E[x]^2`` and updates the running
statistics as ``0.9 * running + 0.1 * batch`` (Flax ``momentum=0.9``) with
the biased variance, which torch's own BatchNorm would store unbiased --
so the update is written out here.  Channel dropout (Flax ``Dropout`` with
``broadcast_dims=(1, 2)``) is a function call, not a submodule, so the
module tree stays the Flax parameter tree.  Its masks come from the
caller's ``torch.Generator``, handed down every ``forward`` as
``generator``, through :func:`dropout_mask`, the one place a mask is
drawn.  Channel padding, bilinear upsampling and the reduced-precision
compute dtypes are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(low, high) padding of Flax/XLA ``padding="SAME"`` along one axis.
    For a stride-2 conv it is asymmetric, e.g. (0, 1) for 16 -> 8 with a
    3x3 kernel, which torch's symmetric ``padding=`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free conv with Flax ``padding="SAME"`` semantics."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, bias: bool = False):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=bias)

    def forward(self, x):
        k, s = self.kernel_size[0], self.stride[0]
        py = same_padding(x.shape[-2], k, s)
        px = same_padding(x.shape[-1], k, s)
        return super().forward(F.pad(x, (px[0], px[1], py[0], py[1])))


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW channels with Flax semantics (momentum 0.9,
    epsilon 1e-5, biased running variance)."""

    MOMENTUM = 0.9  # Flax convention: running = 0.9 running + 0.1 batch

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        mean = x.mean(dim=(0, 2, 3))
        var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0)
        with torch.no_grad():
            m = self.MOMENTUM
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]


def dropout_mask(shape, keep: float, generator, device) -> torch.Tensor:
    """Boolean Bernoulli(``keep``) mask of ``shape`` on ``device``, drawn
    from ``generator`` on the generator's own device.  It never draws from
    torch's global RNG: an active dropout needs the caller's generator."""
    if generator is None:
        raise ValueError("channel dropout in train mode needs a "
                         "torch.Generator for its masks")
    u = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (u < keep).to(device)


def channel_dropout(x, rate: float, training: bool, generator=None):
    """Flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NCHW: whole
    channels of a sample are zeroed, the rest scaled by 1/(1-rate); the
    (N, C, 1, 1) mask comes from :func:`dropout_mask`, which raises
    without a ``generator``."""
    if not training or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(x.shape[:2] + (1, 1), keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def upsample_nearest_2x(x):
    """Exact nearest-neighbour x2 upsampling, NCHW."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


class NormReluConv(nn.Module):
    """BatchNorm -> ReLU -> Conv (-> channel dropout), the repeated motif
    of the codec."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = SameConv2d(in_features, features, kernel, stride)

    def forward(self, x, generator=None):
        x = self.Conv_0(F.relu(self.BatchNorm_0(x)))
        return channel_dropout(x, self.drop_rate, self.training, generator)


class DenseLayer(nn.Module):
    """y = concat(x, conv-path(x)), with the bottleneck design."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 8,
                 bottleneck: bool = False, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        if bottleneck and in_features > bn_size * growth_rate:
            self.NormReluConv_0 = NormReluConv(
                in_features, bn_size * growth_rate, kernel=1)
            self.NormReluConv_1 = NormReluConv(
                bn_size * growth_rate, growth_rate, kernel=3)
        else:
            self.NormReluConv_0 = NormReluConv(in_features, growth_rate,
                                               kernel=3)

    def forward(self, x, generator=None):
        y = x
        for layer in self.children():
            y = layer(y, generator)
        y = channel_dropout(y, self.drop_rate, self.training, generator)
        return torch.cat([x, y], dim=1)


class _GeneratorSequential(nn.Sequential):
    """``nn.Sequential`` that hands the dropout generator to each child."""

    def forward(self, x, generator=None):
        for layer in self:
            x = layer(x, generator)
        return x


class DenseBlock(_GeneratorSequential):
    """num_layers stacked DenseLayers."""

    def __init__(self, in_features: int, num_layers: int, growth_rate: int,
                 bn_size: int = 8, bottleneck: bool = False,
                 drop_rate: float = 0.0):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"DenseLayer_{i}", DenseLayer(
                in_features + i * growth_rate, growth_rate, bn_size,
                bottleneck, drop_rate))


class TransitionDown(_GeneratorSequential):
    """Downsampling transition: norm-relu-conv1x1 -> norm-relu-conv3x3
    (stride 2) with bottleneck (the reference default), else a single
    strided conv3x3."""

    def __init__(self, in_features: int, out_features: int,
                 bottleneck: bool = True, drop_rate: float = 0.0):
        super().__init__()
        if bottleneck:
            self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                               kernel=1, drop_rate=drop_rate)
            self.NormReluConv_1 = NormReluConv(out_features, out_features,
                                               kernel=3, stride=2,
                                               drop_rate=drop_rate)
        else:
            self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                               kernel=3, stride=2,
                                               drop_rate=drop_rate)


class TransitionUp(nn.Module):
    """Upsampling transition: norm-relu-conv1x1 -> norm-relu -> nearest
    x2 -> conv3x3."""

    def __init__(self, in_features: int, out_features: int,
                 drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                           kernel=1, drop_rate=drop_rate)
        self.BatchNorm_0 = BatchNorm(out_features)
        self.Conv_0 = SameConv2d(out_features, out_features, 3)

    def forward(self, x, generator=None):
        x = F.relu(self.BatchNorm_0(self.NormReluConv_0(x, generator)))
        x = self.Conv_0(upsample_nearest_2x(x))
        return channel_dropout(x, self.drop_rate, self.training, generator)


class LastDecoding(nn.Module):
    """Final up-transition emitting the output channels: norm-relu-
    conv3x3(f/2) -> norm-relu -> nearest x2 -> conv3x3(f/4) -> norm-relu
    -> conv5x5(out)."""

    def __init__(self, in_features: int, out_channels: int,
                 drop_rate: float = 0.0, bias: bool = False):
        super().__init__()
        f = in_features
        self.NormReluConv_0 = NormReluConv(f, f // 2, kernel=3,
                                           drop_rate=drop_rate)
        self.BatchNorm_0 = BatchNorm(f // 2)
        self.Conv_0 = SameConv2d(f // 2, f // 4, 3, bias=bias)
        self.BatchNorm_1 = BatchNorm(f // 4)
        self.Conv_1 = SameConv2d(f // 4, out_channels, 5, bias=bias)

    def forward(self, x, generator=None):
        x = F.relu(self.BatchNorm_0(self.NormReluConv_0(x, generator)))
        x = self.Conv_0(upsample_nearest_2x(x))
        return self.Conv_1(F.relu(self.BatchNorm_1(x)))
