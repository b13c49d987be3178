"""Batch sampling helpers.

Port of ``BatchedOverSampler``, ``TensorDataset`` and
``minibatch_indices`` from
``generative_physics_informed_pde_tpu/data/sampling.py``: samplers draw
index tensors from an explicit ``torch.Generator`` on the generator's
device; the dataset is a tuple of aligned arrays indexed by them.  In a
sharded run every process draws the whole minibatch from the same
generator, and :func:`gather_rows` brings it the rows it computes with
from the processes that hold them.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class BatchedOverSampler:
    """``num_batches`` batches of ``batch_size`` indices into
    ``range(num_data)``, drawn uniformly with replacement."""

    batch_size: int
    num_batches: int
    num_data: int

    def __len__(self) -> int:
        return self.num_batches

    def batches(self, generator: torch.Generator) -> Iterator[torch.Tensor]:
        for _ in range(self.num_batches):
            yield torch.randint(0, self.num_data, (self.batch_size,),
                                generator=generator,
                                device=generator.device)


@dataclasses.dataclass(frozen=True)
class TensorDataset:
    """Aligned arrays (tensors or numpy) indexed together."""

    tensors: Tuple

    def __post_init__(self):
        n = self.tensors[0].shape[0]
        if not all(t.shape[0] == n for t in self.tensors):
            raise ValueError("the tensors differ in their first dimension")

    def __len__(self) -> int:
        return self.tensors[0].shape[0]

    def __getitem__(self, index):
        out = tuple(t[index] for t in self.tensors)
        return out[0] if len(out) == 1 else out


def minibatch_indices(generator: Optional[torch.Generator], num_data: int,
                      batch_size: int, device=None, *,
                      replace: bool = False) -> torch.Tensor:
    """Uniform minibatch of ``batch_size`` indices into ``range(num_data)``,
    on ``device`` (default: the generator's): distinct ones, or with
    ``replace`` independent uniform draws."""
    gen_device = generator.device if generator is not None else device
    if replace:
        idx = torch.randint(num_data, (batch_size,), generator=generator,
                            device=gen_device)
    else:
        idx = torch.randperm(num_data, generator=generator,
                             device=gen_device)[:batch_size]
    return idx if device is None else idx.to(device)


def gather_rows(X_local: torch.Tensor, idx: torch.Tensor, lo: int,
                group) -> torch.Tensor:
    """Rows ``idx`` of a batch split over the processes of ``group``, of
    which this process holds rows ``[lo, lo + len(X_local))``, on every
    process: each process writes the rows it holds, zeros elsewhere, and
    the sum over the group keeps each row as its holder wrote it."""
    from ..parallel.distributed import all_reduce_sum

    n = X_local.shape[0]
    mine = (idx >= lo) & (idx < lo + n)
    rows = X_local[(idx - lo).clamp(0, n - 1)]
    keep = mine.reshape((-1,) + (1,) * (rows.ndim - 1))
    return all_reduce_sum(torch.where(keep, rows, torch.zeros_like(rows)),
                          group)
