"""DenseNet encoder/decoder building blocks.

Port of ``generative_physics_informed_pde_tpu/models/codec.py``:
``NormReluConv``, ``DenseLayer``, ``DenseBlock``, ``TransitionDown``,
``TransitionUp``, ``LastDecoding``, the whole encoder-decoder ``DenseED``
with its output activations, ``pad_channels`` and the nearest and bilinear
x2 upsamplings.  Tensors are NCHW inside the modules.  Submodules carry the
Flax module names (``BatchNorm_0``, ``Conv_0``, ``DenseLayer_0``, ...) so
that ``convert.py`` maps a Flax parameter tree onto them path for path.

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
drawn.

Reduced precision follows Flax's module ``dtype`` as the JAX codec uses
it, written as explicit casts: every module takes ``compute_dtype`` (None:
full precision) as a forward-time argument over the same parameters.  A
conv casts its input and kernel to it; BatchNorm reduces its batch
statistics and updates its running averages in at least f32, normalises
in f32 and returns the compute dtype; the parameters stay f32 masters.
``torch.autocast`` is not used: its per-op policy (BatchNorm in f32 with
f32 output) is another function.

:func:`checkpointed` runs a train-mode codec apply under
``torch.utils.checkpoint`` (the JAX package's ``remat_codec``): the
recompute in the backward pass replays the first run's dropout masks and
leaves the BatchNorm running statistics alone, so it is the same math.

Sharded training (:func:`row_split`): when a process holds some rows of
a batch whose other rows other processes hold, a train-mode apply inside
``row_split(split)`` takes the BatchNorm statistics over the whole batch
(differentiable sums over ``split.group`` divided by the whole batch's
count) and draws every dropout mask for the whole batch, keeping its own
rows; so the running statistics and the generator's state stay equal on
every process and equal to the unsharded run's.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class _RematState(threading.local):
    """The dropout masks of a checkpointed apply: recorded on its first
    run, replayed (and the running statistics left alone) on its
    recompute.  Thread-local: a CUDA backward recomputes on the autograd
    engine's own thread."""

    masks = None
    replay = False


_REMAT = _RematState()


class _SplitState(threading.local):
    """The ``row_split`` in force on this thread (None: the plain
    apply)."""

    split = None


_SPLIT = _SplitState()


@contextlib.contextmanager
def row_split(split):
    """Within: train-mode BatchNorm statistics over the whole batch that
    ``split`` (a ``parallel.layout.RowSplit``, or None for the plain
    apply) describes, and dropout masks drawn for the whole batch, this
    process's rows kept."""
    saved = _SPLIT.split
    _SPLIT.split = split
    try:
        yield
    finally:
        _SPLIT.split = saved


def checkpointed(fn, *args):
    """``fn(*args)`` with its activations recomputed in the backward pass
    instead of kept; the recompute draws no dropout mask and updates no
    running statistic, so values, gradients, statistics and the
    generator's state are those of the plain call."""
    masks = []
    runs = [0]
    split = _SPLIT.split

    def run(*a):
        saved = (_REMAT.masks, _REMAT.replay)
        replay = runs[0] > 0
        runs[0] += 1
        _REMAT.masks, _REMAT.replay = (list(masks) if replay else masks,
                                       replay)
        try:
            with row_split(split):
                return fn(*a)
        finally:
            _REMAT.masks, _REMAT.replay = saved

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


def same_padding(size: int, kernel: int, stride: int) -> tuple:
    """(low, high) padding of Flax/XLA ``padding="SAME"`` along one axis.
    For a stride-2 conv it is asymmetric, e.g. (0, 1) for 16 -> 8 with a
    3x3 kernel, which torch's symmetric ``padding=`` cannot express."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """Bias-free conv with Flax ``padding="SAME"`` semantics; with a
    ``compute_dtype`` its input, kernel and bias are cast to it."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 stride: int = 1, bias: bool = False):
        super().__init__(in_features, features, kernel, stride=stride,
                         padding=0, bias=bias)

    def forward(self, x, compute_dtype=None):
        k, s = self.kernel_size[0], self.stride[0]
        py = same_padding(x.shape[-2], k, s)
        px = same_padding(x.shape[-1], k, s)
        x = F.pad(x, (px[0], px[1], py[0], py[1]))
        if compute_dtype is None:
            return super().forward(x)
        bias = None if self.bias is None else self.bias.to(compute_dtype)
        return F.conv2d(x.to(compute_dtype), self.weight.to(compute_dtype),
                        bias, self.stride)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm over NCHW channels with Flax semantics (momentum 0.9,
    epsilon 1e-5, biased running variance).  With a ``compute_dtype`` the
    statistics and the normalisation run in at least f32 and the output
    is cast to it (Flax ``BatchNorm(dtype=...)``)."""

    MOMENTUM = 0.9  # Flax convention: running = 0.9 running + 0.1 batch

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5)

    def forward(self, x, compute_dtype=None):
        if compute_dtype is None and not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, training=False,
                                eps=self.eps)
        out_dtype = x.dtype if compute_dtype is None else compute_dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            split = _SPLIT.split
            if split is None:
                mean = x.mean(dim=(0, 2, 3))
                var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean,
                                  min=0)
            else:
                # the whole batch's sums over the processes holding it
                count = split.n * x.shape[2] * x.shape[3]
                sums = split.sum(torch.stack([x.sum(dim=(0, 2, 3)),
                                              (x * x).sum(dim=(0, 2, 3))]))
                mean = sums[0] / count
                var = torch.clamp(sums[1] / count - mean * mean, min=0)
            if not _REMAT.replay:
                with torch.no_grad():
                    m = self.MOMENTUM
                    self.running_mean.copy_(m * self.running_mean
                                            + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var
                                           + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(out_dtype)


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


def dropout(x, rate: float, training: bool, generator=None, shape=None):
    """Flax ``Dropout(rate)``: entries zeroed by a Bernoulli mask of
    ``shape`` (default ``x``'s; broadcast over the rest), the others
    scaled by 1/(1-rate); the mask comes from :func:`dropout_mask`, which
    raises without a ``generator`` (inside :func:`checkpointed`: recorded
    on the first run, replayed on the recompute)."""
    if not training or rate <= 0:
        return x
    keep = 1.0 - rate
    if _REMAT.replay:
        mask = _REMAT.masks.pop(0)
    else:
        shape = tuple(x.shape if shape is None else shape)
        split = _SPLIT.split
        if split is None:
            mask = dropout_mask(shape, keep, generator, x.device)
        else:  # the whole batch's mask, this process's rows
            mask = split.take(dropout_mask((split.n,) + shape[1:], keep,
                                           generator, x.device))
        if _REMAT.masks is not None:
            _REMAT.masks.append(mask)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def channel_dropout(x, rate: float, training: bool, generator=None):
    """Flax ``Dropout(rate, broadcast_dims=(1, 2))`` on NCHW: whole
    channels of a sample are zeroed by an (N, C, 1, 1) mask."""
    return dropout(x, rate, training, generator, x.shape[:2] + (1, 1))


def upsample_nearest_2x(x):
    """Exact nearest-neighbour x2 upsampling, NCHW."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)


def upsample_bilinear_2x(x):
    """Bilinear x2 upsampling with ``align_corners=True`` (torch
    ``UpsamplingBilinear2d(scale_factor=2)``), NCHW: output index i
    samples input coordinate ``i (n-1) / (2n-1)``, a single row is
    copied."""
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=True)


UPSAMPLE = {"nearest": upsample_nearest_2x,
            "bilinear": upsample_bilinear_2x}


def _upsample(kind: str):
    if kind not in UPSAMPLE:
        raise ValueError(f"upsample={kind!r}: one of {sorted(UPSAMPLE)}")
    return UPSAMPLE[kind]


class NormReluConv(nn.Module):
    """BatchNorm -> ReLU -> Conv (-> channel dropout), the repeated motif
    of the codec."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, drop_rate: float = 0.0):
        super().__init__()
        self.drop_rate = drop_rate
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = SameConv2d(in_features, features, kernel, stride)

    def forward(self, x, generator=None, compute_dtype=None):
        x = self.Conv_0(F.relu(self.BatchNorm_0(x, compute_dtype)),
                        compute_dtype)
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

    def forward(self, x, generator=None, compute_dtype=None):
        y = x
        for layer in self.children():
            y = layer(y, generator, compute_dtype)
        y = channel_dropout(y, self.drop_rate, self.training, generator)
        return torch.cat([x, y], dim=1)


class _GeneratorSequential(nn.Sequential):
    """``nn.Sequential`` that hands the dropout generator and the compute
    dtype to each child."""

    def forward(self, x, generator=None, compute_dtype=None):
        for layer in self:
            x = layer(x, generator, compute_dtype)
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
    """Upsampling transition: norm-relu-conv1x1 -> norm-relu -> x2
    (``upsample``: 'nearest' or 'bilinear') -> conv3x3."""

    def __init__(self, in_features: int, out_features: int,
                 drop_rate: float = 0.0, upsample: str = "nearest"):
        super().__init__()
        self.drop_rate = drop_rate
        self.upsample = _upsample(upsample)
        self.NormReluConv_0 = NormReluConv(in_features, out_features,
                                           kernel=1, drop_rate=drop_rate)
        self.BatchNorm_0 = BatchNorm(out_features)
        self.Conv_0 = SameConv2d(out_features, out_features, 3)

    def forward(self, x, generator=None, compute_dtype=None):
        cd = compute_dtype
        x = F.relu(self.BatchNorm_0(self.NormReluConv_0(x, generator, cd),
                                    cd))
        x = self.Conv_0(self.upsample(x), cd)
        return channel_dropout(x, self.drop_rate, self.training, generator)


class LastDecoding(nn.Module):
    """Final up-transition emitting the output channels: norm-relu-
    conv3x3(f/2) -> norm-relu -> x2 -> conv3x3(f/4) -> norm-relu
    -> conv5x5(out)."""

    def __init__(self, in_features: int, out_channels: int,
                 drop_rate: float = 0.0, bias: bool = False,
                 upsample: str = "nearest"):
        super().__init__()
        f = in_features
        self.upsample = _upsample(upsample)
        self.NormReluConv_0 = NormReluConv(f, f // 2, kernel=3,
                                           drop_rate=drop_rate)
        self.BatchNorm_0 = BatchNorm(f // 2)
        self.Conv_0 = SameConv2d(f // 2, f // 4, 3, bias=bias)
        self.BatchNorm_1 = BatchNorm(f // 4)
        self.Conv_1 = SameConv2d(f // 4, out_channels, 5, bias=bias)

    def forward(self, x, generator=None, compute_dtype=None):
        cd = compute_dtype
        x = F.relu(self.BatchNorm_0(self.NormReluConv_0(x, generator, cd),
                                    cd))
        x = self.Conv_0(self.upsample(x), cd)
        return self.Conv_1(F.relu(self.BatchNorm_1(x, cd)), cd)


def pad_channels(x, multiple: int, dim: int = -1):
    """Zero-pad dimension ``dim`` (default the last, the JAX package's
    channel axis) up to a multiple of ``multiple``; 0 or less leaves ``x``
    as it is.  Feeding a conv, zero input channels add nothing to its
    output, which is why the port's codecs run their convs unpadded."""
    if multiple <= 0:
        return x
    rem = x.shape[dim] % multiple
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[dim] = multiple - rem
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def softplus4(x):
    """torch ``Softplus(beta=4)``."""
    return F.softplus(x, beta=4.0)


ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "lrelu": F.leaky_relu,
    "sigmoid": torch.sigmoid,
    "softplus": softplus4,
}


class DenseED(nn.Module):
    """The whole dense encoder-decoder: in-conv (7x7, stride 2) ->
    [DenseBlock, TransitionDown] x enc -> [DenseBlock, (TransitionUp)] x
    dec -> LastDecoding, the block list split in half (``blocks`` of odd
    length, else ``ValueError``).  Images are NHWC in and out, the JAX
    package's layout: (N, H, W, in_channels) -> (N, H, W, out_channels).
    ``dtype`` is the conv compute dtype (None: full precision; the output
    is cast back to the input's), ``out_activation`` one of
    ``ACTIVATIONS`` or None.  ``pad_cin`` is kept for the JAX package's
    signature: zero input channels add nothing to a conv, so the port runs
    the convs unpadded (``convert.py`` drops a padded kernel's extra
    rows).  In train mode (``module.train()``) BatchNorm uses the batch
    statistics and channel dropout draws its masks from ``generator``."""

    def __init__(self, out_channels: int, blocks, growth_rate: int = 16,
                 init_features: int = 48, drop_rate: float = 0.0,
                 bn_size: int = 8, bottleneck: bool = False,
                 upsample: str = "nearest", out_activation=None,
                 pad_cin: int = 0, dtype=None, in_channels: int = 1):
        super().__init__()
        blocks = list(blocks)
        if len(blocks) > 1 and len(blocks) % 2 == 0:
            raise ValueError("length of blocks must be odd")
        if out_activation is not None and out_activation not in ACTIVATIONS:
            raise ValueError(f"out_activation={out_activation!r}: one of "
                             f"{sorted(ACTIVATIONS)}")
        enc = blocks[:len(blocks) // 2]
        dec = blocks[len(blocks) // 2:]
        self.out_activation = out_activation
        self.pad_cin = pad_cin
        self.compute_dtype = dtype
        # registered in the order forward runs them; Flax numbers each
        # submodule type on its own: DenseBlock_0..n across encoder and
        # decoder, TransitionDown_i, TransitionUp_i
        self.Conv_0 = SameConv2d(in_channels, init_features, 7, stride=2)
        nf = init_features
        for i, nl in enumerate(enc):
            self.add_module(f"DenseBlock_{i}", DenseBlock(
                nf, nl, growth_rate, bn_size, bottleneck, drop_rate))
            nf += nl * growth_rate
            self.add_module(f"TransitionDown_{i}", TransitionDown(
                nf, nf // 2, drop_rate=drop_rate))
            nf //= 2
        for i, nl in enumerate(dec):
            self.add_module(f"DenseBlock_{len(enc) + i}", DenseBlock(
                nf, nl, growth_rate, bn_size, bottleneck, drop_rate))
            nf += nl * growth_rate
            if i < len(dec) - 1:
                self.add_module(f"TransitionUp_{i}", TransitionUp(
                    nf, nf // 2, drop_rate, upsample))
                nf //= 2
        self.LastDecoding_0 = LastDecoding(nf, out_channels, drop_rate,
                                           upsample=upsample)

    def forward(self, x, generator=None, compute_dtype=None):
        cd = compute_dtype or self.compute_dtype
        in_dtype = x.dtype
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
        if cd is not None:
            x = x.to(cd)
        x = self.Conv_0(x, cd)
        for block in list(self.children())[1:]:
            x = block(x, generator, cd)
        x = x.to(in_dtype).permute(0, 2, 3, 1)
        if self.out_activation is not None:
            x = ACTIVATIONS[self.out_activation](x)
        return x
