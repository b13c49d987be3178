"""Parallel execution: device meshes, study pools, device and process
sweeps, multi-process distribution on ``torch.distributed``.

The sharded-training names of the JAX package (``replicated``,
``batch_sharding``, ``mc_batch_sharding``, ``shard_train_state``,
``make_hybrid_mesh``, ``global_array_from_local``) are not ported yet."""

from .mesh import (LocalMesh, make_mesh, batch_pspec, shard_data_dict,
                   gather_batch)
from .study import (DummyFuture, DummyProcessPool, ThreadPool,
                    sweep_over_devices)
from .distributed import (initialize, process_count, process_index,
                          local_shard_slice, all_gather_rows, fetch,
                          sweep_over_processes)

__all__ = ["LocalMesh", "make_mesh", "batch_pspec", "shard_data_dict",
           "gather_batch", "DummyFuture", "DummyProcessPool", "ThreadPool",
           "sweep_over_devices", "initialize", "process_count",
           "process_index", "local_shard_slice", "all_gather_rows", "fetch",
           "sweep_over_processes"]
