"""DenseNet encoder building blocks, inference (eval) mode.

Port of the pieces of ``generative_physics_informed_pde_tpu/models/
codec.py`` that ``CNNEncoder`` uses: ``NormReluConv``, ``DenseLayer``,
``DenseBlock`` and ``TransitionDown``.  Tensors are NCHW inside the
modules.  Submodules carry the Flax module names (``BatchNorm_0``,
``Conv_0``, ``DenseLayer_0``, ...) so that ``convert.py`` maps a Flax
parameter tree onto them path for path.

BatchNorm always reads its stored running statistics (Flax
``use_running_average=True``, epsilon 1e-5); training mode, dropout and
channel padding are not ported yet.
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
    """BatchNorm over NCHW channels that always uses the running stats."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x):
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, training=False,
                            eps=self.eps)


class NormReluConv(nn.Module):
    """BatchNorm -> ReLU -> Conv, the repeated motif of the codec."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = SameConv2d(in_features, features, kernel, stride)

    def forward(self, x):
        return self.Conv_0(F.relu(self.BatchNorm_0(x)))


class DenseLayer(nn.Module):
    """y = concat(x, conv-path(x)), with the bottleneck design."""

    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 8,
                 bottleneck: bool = False):
        super().__init__()
        if bottleneck and in_features > bn_size * growth_rate:
            self.NormReluConv_0 = NormReluConv(
                in_features, bn_size * growth_rate, kernel=1)
            self.NormReluConv_1 = NormReluConv(
                bn_size * growth_rate, growth_rate, kernel=3)
        else:
            self.NormReluConv_0 = NormReluConv(in_features, growth_rate,
                                               kernel=3)

    def forward(self, x):
        y = x
        for layer in self.children():
            y = layer(y)
        return torch.cat([x, y], dim=1)


class DenseBlock(nn.Sequential):
    """num_layers stacked DenseLayers."""

    def __init__(self, in_features: int, num_layers: int, growth_rate: int,
                 bn_size: int = 8, bottleneck: bool = False):
        super().__init__()
        for i in range(num_layers):
            self.add_module(f"DenseLayer_{i}", DenseLayer(
                in_features + i * growth_rate, growth_rate, bn_size,
                bottleneck))


class TransitionDown(nn.Sequential):
    """Downsampling transition: norm-relu-conv1x1 -> norm-relu-conv3x3
    (stride 2) with bottleneck (the reference default), else a single
    strided conv3x3."""

    def __init__(self, in_features: int, out_features: int,
                 bottleneck: bool = True):
        super().__init__()
        if bottleneck:
            self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                               kernel=1)
            self.NormReluConv_1 = NormReluConv(out_features, out_features,
                                               kernel=3, stride=2)
        else:
            self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                               kernel=3, stride=2)
