"""Where one sharded training step's batches lie across the processes.

The sharded trainer (``Trainer.setup(mesh=...)``) computes on local
tensors and makes its collectives explicit.  Every batch of the step is
split over the mesh's batch axes (``batch_pspec``), whole on every place
of the other axes (its replicas), except the Monte-Carlo batch under
``mc_batch_sharding``, which is split over all axes.  A ``RowSplit`` says
which rows of one batch this process holds and over which processes its
sums run; ``TrainLayout`` makes them for a mesh.

A batch of ``n`` rows over ``k`` shards lies as GSPMD lays out a
dimension that does not divide: ``ceil(n / k)`` rows a shard, in shard
order, the last shards short or empty (``share``).  Only batches that
have no per-datapoint state may be uneven: the amortized unlabeled
minibatch and the Monte-Carlo rows of a batch-axes block, which are split
over that block's replicas.  The per-datapoint blocks (the posteriors and
their data) always divide; the trainer refuses them otherwise, as the JAX
package does.

The virtual observables and the analyses follow the same layout: the VO
ensemble's ``N_vo`` rows and the analysed datasets' rows are split over
the batch axes (``rows``), whole on every replica, and every Monte-Carlo
draw over them is made whole and cut (``RowSplit.repeat``, ``take``).

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


def share(n: int, k: int, i: int) -> Tuple[int, int]:
    """The rows ``[lo, hi)`` that shard ``i`` of ``k`` holds of a
    dimension of ``n`` rows: ``ceil(n / k)`` a shard, the last ones short
    or empty (GSPMD's layout; equal blocks when ``k`` divides ``n``)."""
    c = -(-n // k)
    return min(i * c, n), min((i + 1) * c, n)


@dataclasses.dataclass(frozen=True)
class RowSplit:
    """This process holds rows ``segments`` ((lo, hi) pairs, ascending) of
    a batch of ``n`` rows; ``group`` is the process group that holds the
    rest of it (None: this process holds it all, or no other process
    computes with it)."""

    n: int
    segments: Tuple[Tuple[int, int], ...]
    group: Any = None

    @staticmethod
    def whole(n: int) -> "RowSplit":
        """All ``n`` rows on this process (the unsharded split)."""
        return RowSplit(n, ((0, n),))

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

    def repeat(self, m: int) -> "RowSplit":
        """The split of the ``n * m`` rows that repeat each row ``m``
        times, row-major (the Monte-Carlo samples of this split's rows)."""
        return RowSplit(self.n * m, tuple((lo * m, hi * m)
                                          for lo, hi in self.segments),
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
    """The batches of a training step on ``mesh``: ``rows(n)``, a batch
    of ``n`` rows split over the batch axes of ``axis``
    (``batch_sharding``); ``block(n_local)``, a per-datapoint block of
    ``n_local`` rows a process; and ``joint(n, n_mc)``, the ``n * n_mc``
    Monte-Carlo rows of a batch of ``n`` split over all axes, batch axes
    major (``mc_batch_sharding`` on a mesh whose batch axes come
    first)."""

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

    def rows(self, n: int) -> RowSplit:
        """This process's share of a batch of ``n`` rows over the batch
        axes."""
        return RowSplit(n, (share(n, self.k_rows, self.r),),
                        self.rows_group)

    def block(self, n_local: int) -> RowSplit:
        """The split of a per-datapoint block of which every process of
        the batch axes holds ``n_local`` rows (such a block always
        divides: ``Trainer.setup`` refuses any other)."""
        return self.rows(n_local * self.k_rows)

    def joint(self, n: int, n_mc: int) -> RowSplit:
        """The ``n * n_mc`` Monte-Carlo rows (N-major) of a batch of ``n``
        rows: each batch-axes block's rows split over its replicas
        (``replica_block``), so that a process decodes rows of its own
        data only."""
        lo, hi = share(n, self.k_rows, self.r)
        a, b = share((hi - lo) * n_mc, self.k_other, self.m)
        return RowSplit(n * n_mc, ((lo * n_mc + a, lo * n_mc + b),),
                        self.world_group)

    def replica_block(self, x: torch.Tensor) -> torch.Tensor:
        """This process's block of ``x`` split over the replica axes: the
        local share, in ``joint``'s order, of a batch whose rows this
        process's replicas all hold."""
        lo, hi = share(x.shape[0], self.k_other, self.m)
        return x[lo:hi]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """All rows of a per-datapoint block split over the batch axes
        (equal blocks; an uneven batch is never gathered)."""
        return self.rows_sharding.gather(x)

    def check_rows(self, what: str, n: int) -> None:
        """Refuse a per-datapoint block of ``n`` rows that does not divide
        by the batch axes' shard count."""
        if n % self.k_rows:
            raise ValueError(
                f"{what} ({n}) does not split over the {self.k_rows} "
                f"shards of the batch axes {self.rows_sharding.axes}: its "
                "per-datapoint blocks cannot be split unevenly (the JAX "
                "package refuses it too)")
