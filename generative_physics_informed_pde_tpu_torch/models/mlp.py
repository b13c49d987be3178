"""Generic feed-forward networks.

Port of ``FeedforwardNeuralNetwork`` and ``architecture_from_linear_decay``
from ``generative_physics_informed_pde_tpu/models/mlp.py``: dense layers
named ``Dense_0``, ``Dense_1``, ... as Flax names them, ReLU on the hidden
layers, optional dropout after every dense layer and an optional output
activation.  Flax infers the input width; here it is ``dim_in``.  Dropout
masks (element-wise, Flax ``Dropout(rate)``) come from the caller's
``torch.Generator`` through ``codec.dropout_mask``.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch.nn.functional as F
from torch import nn

import numpy as np

from .codec import dropout


def architecture_from_linear_decay(dim_in: int, dim_out: int,
                                   num_hidden_layers: int) -> list:
    """Hidden widths interpolated linearly from ``dim_in`` to ``dim_out``
    (numpy ``linspace``, truncated to int, ends dropped)."""
    widths = np.linspace(dim_in, dim_out, num_hidden_layers + 2).astype(int)
    return [int(w) for w in widths[1:-1]]


class FeedforwardNeuralNetwork(nn.Module):
    """MLP with ReLU hidden activations, optional dropout and output
    activation."""

    def __init__(self, dim_in: int, dim_out: int,
                 architecture: Sequence[int] = (),
                 out_activation: Optional[Callable] = None,
                 dropout: Optional[float] = None):
        super().__init__()
        self.architecture = [int(w) for w in architecture]
        self.out_activation = out_activation
        self.dropout = dropout
        n_in = dim_in
        for i, w in enumerate(self.architecture + [dim_out]):
            self.add_module(f"Dense_{i}", nn.Linear(n_in, w))
            n_in = w
        self.n_dense = len(self.architecture) + 1

    def _drop(self, x, generator):
        if self.dropout is None:
            return x
        return dropout(x, self.dropout, self.training, generator)

    def forward(self, x, generator=None):
        """Train mode (``module.train()``) draws the dropout masks from
        ``generator``."""
        for i in range(self.n_dense - 1):
            x = F.relu(self._drop(getattr(self, f"Dense_{i}")(x), generator))
        x = self._drop(getattr(self, f"Dense_{self.n_dense - 1}")(x),
                       generator)
        if self.out_activation is not None:
            x = self.out_activation(x)
        return x

    @classmethod
    def from_linear_decay(cls, dim_in: int, dim_out: int,
                          num_hidden_layers: int, **kw):
        widths = architecture_from_linear_decay(dim_in, dim_out,
                                                num_hidden_layers)
        return cls(dim_in, dim_out, architecture=widths, **kw)

    FromLinearDecay = from_linear_decay
