"""Serving of the extracted discriminative surrogate with static batch
buckets.

Port of ``SurrogateBundle`` from
``generative_physics_informed_pde_tpu/serving.py``: the same buckets
(8, 64, 512), pad-to-bucket, streaming of larger requests through the
largest bucket and the same input validation.  Per bucket the bundle holds
a callable on a frozen copy of the eager module.  StableHLO export and
``save``/``load`` are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch

from .utils.device import resolve_device

DEFAULT_BUCKETS = (8, 64, 512)


def surrogate_fn(discriminative, *, dtype=torch.float32, device="cuda",
                 use_encoder: bool = True) -> Callable:
    """Freeze a surrogate into a pure ``f(x, F) -> y``: a deep copy of the
    module in eval mode on ``device``, so later training of the original
    does not change what is served."""
    snap = copy.deepcopy(discriminative).to(
        device=resolve_device(device), dtype=dtype).eval()

    def fn(x, F):
        return snap(x, F, use_encoder=use_encoder)

    return fn


@dataclasses.dataclass
class SurrogateBundle:
    """A set of surrogate callables, one per static batch bucket."""

    buckets: Tuple[int, ...]
    image_shape: Tuple[int, ...]
    dim_F: int
    dtype: torch.dtype
    device: torch.device
    calls: Dict[int, Callable]

    @classmethod
    def build(cls, discriminative, image_shape: Sequence[int], dim_F: int, *,
              buckets: Sequence[int] = DEFAULT_BUCKETS,
              dtype=torch.float32, device="cuda",
              use_encoder: bool = True) -> "SurrogateBundle":
        device = resolve_device(device)
        if not buckets:
            raise ValueError("buckets must be non-empty")
        fn = surrogate_fn(discriminative, dtype=dtype, device=device,
                          use_encoder=use_encoder)
        bs = tuple(sorted(set(int(b) for b in buckets)))
        return cls(buckets=bs,
                   image_shape=tuple(int(s) for s in image_shape),
                   dim_F=int(dim_F), dtype=dtype, device=device,
                   calls={b: fn for b in bs})

    def predict(self, x, F) -> torch.Tensor:
        """Serve a request of any batch size: pad up to the smallest bucket
        that fits; stream requests beyond the largest bucket through it in
        chunks (the last one padded).  Returns exactly ``x.shape[0]``
        rows."""
        x, F = self._as_input(x), self._as_input(F)
        if x.dim() == 0 or F.dim() == 0:
            raise ValueError("x and F must be batched arrays, got a scalar")
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty request")
        if F.shape[0] != n:
            raise ValueError(f"x batch {n} != F batch {F.shape[0]}")
        if tuple(x.shape[1:]) != self.image_shape:
            raise ValueError(f"x image shape {tuple(x.shape[1:])} != "
                             f"exported {self.image_shape}")
        if tuple(F.shape[1:]) != (self.dim_F,):
            raise ValueError(f"F feature dim {tuple(F.shape[1:])} != "
                             f"({self.dim_F},)")
        cap = self.buckets[-1]
        if n <= cap:
            return self._call_padded(x, F, n)
        outs = []
        for i in range(0, n, cap):
            xs, fs = x[i:i + cap], F[i:i + cap]
            outs.append(self._call_padded(xs, fs, xs.shape[0]))
        return torch.cat(outs, dim=0)

    def _as_input(self, a) -> torch.Tensor:
        """Cast to the bundle's dtype and device; host arrays are copied
        (they may be read-only, which ``torch.as_tensor`` cannot alias)."""
        if isinstance(a, torch.Tensor):
            return a.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(a), dtype=self.dtype,
                            device=self.device)

    def _call_padded(self, x, F, n: int) -> torch.Tensor:
        bucket = next(b for b in self.buckets if b >= n)
        if n < bucket:
            pad = bucket - n
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            F = torch.cat([F, F.new_zeros((pad,) + tuple(F.shape[1:]))])
        return self.calls[bucket](x, F)[:n]
