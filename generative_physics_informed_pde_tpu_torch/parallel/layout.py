"""Where one sharded training step's batches lie across the processes.

The sharded trainer (``Trainer.setup(mesh=...)``) computes on local
tensors and makes its collectives explicit.  Every batch of the step is
split over the mesh's batch axes (``batch_pspec``), whole on every place
of the other axes (its replicas), except the Monte-Carlo batch under
``mc_batch_sharding``, which is split over all axes.  A ``RowSplit`` says
which rows of one batch this process holds and over which processes its
sums run; ``TrainLayout`` makes them for a mesh.

Sums over a batch that repeats on the replicas are counted by the first
replica only (``first_replica``), and terms that depend on no rows (the
l2 penalty) by process 0 only (``lead``), so that the sum over all
processes of each process's share of the ELBO is the ELBO.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch

from .distributed import differentiable_sum, process_index
from .mesh import Sharding, batch_sharding


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This process holds rows ``segments`` ((lo, hi) pairs, ascending) of
    a batch of ``n`` rows; ``group`` is the process group that holds the
    rest of it (None: this process holds it all, or no other process
    computes with it)."""

    n: int
    segments: Tuple[Tuple[int, int], ...]
    group: Any = None

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``x``, a tensor of all ``n`` rows."""
        if len(self.segments) == 1:
            lo, hi = self.segments[0]
            return x if (lo, hi) == (0, x.shape[0]) else x[lo:hi]
        return torch.cat([x[lo:hi] for lo, hi in self.segments])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the group, differentiably."""
        return x if self.group is None else differentiable_sum(x,
                                                               self.group)

    @staticmethod
    def concat(splits: Sequence["RowSplit"]) -> "RowSplit":
        """The split of the batches of ``splits`` concatenated (all over
        one group)."""
        groups = {id(s.group) for s in splits}
        if len(groups) != 1:
            raise ValueError("concatenated batches lie over different "
                             "process groups")
        segs, off = [], 0
        for s in splits:
            segs += [(lo + off, hi + off) for lo, hi in s.segments]
            off += s.n
        return RowSplit(off, tuple(segs), splits[0].group)


class TrainLayout:
    """The batches of a training step on ``mesh``: ``rows(n_local)``, a
    batch of ``n_local`` rows a process split over the batch axes of
    ``axis`` (``batch_sharding``), and ``joint(n_local)``, one split over
    all axes, batch axes major (``mc_batch_sharding`` on a mesh whose
    batch axes come first)."""

    def __init__(self, mesh, axis: str = "dp"):
        self.mesh = mesh
        self.rows_sharding = batch_sharding(mesh, axis)
        names = tuple(mesh.mesh_dim_names)
        other = tuple(a for a in names if a not in self.rows_sharding.axes)
        self.replica_sharding = Sharding(mesh, other)
        self.k_rows = self.rows_sharding.num_shards
        self.k_other = self.replica_sharding.num_shards
        self.world = mesh.size()
        coord = mesh.get_coordinate()
        self.r = self.rows_sharding.shard_index(coord)
        self.m = self.replica_sharding.shard_index(coord)
        self.rows_group = self.rows_sharding.group()
        self.replica_group = self.replica_sharding.group()
        self.world_group = None if self.world == 1 else mesh.group(names)
        self.first_replica = self.m == 0
        self.lead = self.world == 1 or process_index() == 0

    def global_rows(self, n_local: int) -> int:
        return n_local * self.k_rows

    def rows(self, n_local: int) -> RowSplit:
        lo = self.r * n_local
        return RowSplit(self.global_rows(n_local), ((lo, lo + n_local),),
                        self.rows_group)

    def joint(self, n_local: int) -> RowSplit:
        j = self.r * self.k_other + self.m
        return RowSplit(n_local * self.world,
                        ((j * n_local, (j + 1) * n_local),),
                        self.world_group)

    def replica_block(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of ``x`` split over the replica axes: the
        local share, in ``joint``'s order, of a batch whose rows this
        process's replicas all hold."""
        per = x.shape[0] // self.k_other
        return x[self.m * per:(self.m + 1) * per]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All rows of a batch split over the batch axes."""
        return self.rows_sharding.gather(x)

    def check_rows(self, what: str, n: int) -> None:
        if n % self.k_rows:
            raise ValueError(f"{what} ({n}) does not split over the "
                             f"{self.k_rows} shards of the batch axes "
                             f"{self.rows_sharding.axes}")


def mc_rows(layout: TrainLayout, n_local: int, n_mc: int) -> int:
    """The Monte-Carlo rows a process decodes under
    ``mc_batch_sharding``: its data rows' ``n_local * n_mc`` over the
    replicas (which must split them)."""
    total = n_local * n_mc
    if total % layout.k_other:
        raise ValueError(f"{total} Monte-Carlo rows do not split over the "
                         f"{layout.k_other} replicas")
    return total // layout.k_other

