"""Parallel execution: device meshes, shardings and the sharded training
state, study pools, device and process sweeps, multi-process distribution
on ``torch.distributed``."""

from .mesh import (LocalMesh, ProcessMesh, Sharding, make_mesh,
                   replicated, batch_pspec, batch_sharding,
                   mc_batch_sharding, shard_data_dict, gather_batch,
                   shard_train_state)
from .study import (DummyFuture, DummyProcessPool, ThreadPool,
                    sweep_over_devices)
from .distributed import (initialize, process_count, process_index,
                          make_hybrid_mesh, local_shard_slice,
                          global_array_from_local, all_gather_rows, fetch,
                          sweep_over_processes)

__all__ = ["LocalMesh", "ProcessMesh", "Sharding", "make_mesh",
           "replicated", "batch_pspec", "batch_sharding",
           "mc_batch_sharding", "shard_data_dict", "gather_batch",
           "shard_train_state", "DummyFuture", "DummyProcessPool",
           "ThreadPool", "sweep_over_devices", "initialize",
           "process_count", "process_index", "make_hybrid_mesh",
           "local_shard_slice", "global_array_from_local",
           "all_gather_rows", "fetch", "sweep_over_processes"]
