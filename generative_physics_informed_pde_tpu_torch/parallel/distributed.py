"""Multi-process distribution on ``torch.distributed``.

The port's counterpart of ``generative_physics_informed_pde_tpu/parallel/
distributed.py``.  JAX runs one SPMD program over one global mesh; PyTorch
runs one process per device, joined in a process group: every process
runs the same script, ``initialize`` wires the group, each process works
on its contiguous share of a batch (``local_shard_slice``) and collectives
bring the shares together (``fetch``, ``all_gather_rows``,
``all_reduce_sum``, ``sweep_over_processes``).  Where JAX has hosts (DCN)
and each host's devices (ICI), PyTorch has nodes and each node's
processes: ``make_hybrid_mesh`` puts its leading ``dcn`` axis over the
nodes and its trailing axes over a node's processes.

Backends: gloo on the CPU; on CUDA nccl, unless a node runs more
processes than it has cards, where nccl refuses two ranks on one card and
gloo is used instead (``backend_for``).  Gloo carries all-reduce and
broadcast of CUDA tensors; its other collectives take host tensors, so the
helpers here stage CUDA tensors through the host for them.

Typical use (the same script in every process, under ``torchrun`` or
with explicit wiring):

    from generative_physics_informed_pde_tpu_torch import parallel
    parallel.initialize(device="cpu")      # env-driven under torchrun
    mesh = parallel.make_mesh(device="cpu")
    trainer.setup(scheduler_spec=..., mesh=mesh)

For explicit wiring (tests, custom launchers) pass
``coordinator_address`` (an init method such as ``tcp://host:port`` or
``file:///path``), ``num_processes`` and ``process_id``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

# torchrun's signals of a multi-process job, and what env:// needs of them
_SIGNALS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")
_ENV_NEEDS = _SIGNALS + ("MASTER_PORT",)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, device="cuda") -> bool:
    """Idempotent ``torch.distributed.init_process_group`` wrapper.

    With no arguments it joins the group that the environment describes
    (torchrun's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``) whenever any of those signals is set; with none set
    it returns False WITHOUT touching ``torch.distributed``, so a later
    call with explicit arguments still works.  The backend is
    ``backend_for(device, processes a node)``: gloo on the CPU, nccl on
    CUDA, gloo on CUDA when a node runs more processes than it has cards
    (the processes of a node: ``LOCAL_WORLD_SIZE``, else all of them).  A
    CUDA process uses card ``LOCAL_RANK``, else its rank, modulo the card
    count, or the one card of ``local_device_ids`` (a list of one index:
    a process of the port drives one card, so more than one id is refused,
    and on the CPU it must be None).  Returns True if the group spans more
    than one process.

    A half-initialised job raises, never falls back to one process: an
    environment with some of the signals but not all of what ``env://``
    needs, explicit wiring without ``num_processes`` and ``process_id``,
    and a second call whose world size or rank differs from the group
    already up.
    """
    if local_device_ids is not None:
        local_device_ids = [int(i) for i in local_device_ids]
        if torch.device(device).type != "cuda":
            raise ValueError(f"local_device_ids={local_device_ids} names "
                             f"cards; with device={device!r} it must be None")
        if len(local_device_ids) != 1:
            raise ValueError(f"local_device_ids={local_device_ids}: a "
                             "process drives one card, give one id")
    if dist.is_initialized():
        if (num_processes is not None
                and num_processes != dist.get_world_size()) \
                or (process_id is not None
                    and process_id != dist.get_rank()):
            raise RuntimeError(
                f"torch.distributed is already up as rank "
                f"{dist.get_rank()} of {dist.get_world_size()}; asked for "
                f"rank {process_id} of {num_processes}")
        return dist.get_world_size() > 1
    present = [k for k in _SIGNALS if k in os.environ]
    if coordinator_address is None and not present:
        # no cluster signal: one process, and nothing touched
        return False
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("explicit wiring needs coordinator_address, "
                             "num_processes and process_id")
        kw = dict(init_method=coordinator_address, world_size=num_processes,
                  rank=process_id)
        rank = process_id
    else:
        missing = [k for k in _ENV_NEEDS if k not in os.environ]
        if missing:
            raise RuntimeError(f"half-configured multi-process environment:"
                               f" {present} set, {missing} missing")
        kw = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    dev = resolve_device(device)
    world = int(kw.get("world_size") or os.environ["WORLD_SIZE"])
    backend = backend_for(dev, int(os.environ.get("LOCAL_WORLD_SIZE",
                                                  world)))
    if dev.type == "cuda":
        torch.cuda.set_device(
            local_device_ids[0] if local_device_ids is not None
            else int(os.environ.get("LOCAL_RANK", rank))
            % torch.cuda.device_count())
    dist.init_process_group(backend, **kw)
    return dist.get_world_size() > 1


def backend_for(device, processes_per_node: int) -> str:
    """The process group's backend: gloo on the CPU; on CUDA nccl, or gloo
    when a node runs more processes than it has cards (nccl refuses two
    ranks on one card).  The rule is fixed up front, never a fallback
    after a failure."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "gloo" if processes_per_node > torch.cuda.device_count() \
        else "nccl"


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_shard_slice(n: int) -> slice:
    """The [start, stop) slice of a length-``n`` global batch this process
    owns under contiguous process-major sharding."""
    p, np_ = process_index(), process_count()
    if n % np_:
        raise ValueError(f"global batch {n} not divisible by "
                         f"{np_} processes")
    per = n // np_
    return slice(p * per, (p + 1) * per)


def _staged(x: torch.Tensor, group) -> bool:
    """Whether a collective other than all-reduce and broadcast must take
    ``x`` through the host: a CUDA tensor under gloo."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) of ``group`` (default: all),
    concatenated along the first axis in rank order, on every process, on
    ``x``'s device; ``x`` itself with one process."""
    if process_count() == 1 or group is not None \
            and dist.get_world_size(group) == 1:
        return x
    src = x.contiguous()
    if _staged(x, group):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every process's ``x`` over ``group`` (default: all), in
    place, on every process; ``x`` itself with one process.  Gloo and nccl
    both reduce CUDA tensors, and every process gets the same bits."""
    if process_count() > 1 and (group is None
                                or dist.get_world_size(group) > 1):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


class _AllReduceSum(torch.autograd.Function):
    """Differentiable sum over a group: the gradient of every process's
    input is the sum of the gradients of every process's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_sum(grad.contiguous().clone(), ctx.group), None


def differentiable_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce_sum`` that autograd differentiates (every process of
    ``group`` must run the backward pass through it)."""
    return _AllReduceSum.apply(x, group)


def barrier() -> None:
    """Wait for every process of the group (nothing with one)."""
    if process_count() > 1:
        dist.barrier()


def make_hybrid_mesh(local_axis_names: Sequence[str] = ("dp",),
                     local_shape: Optional[Sequence[int]] = None,
                     dcn_axis: str = "dcn", device="cuda"):
    """Explicit (nodes x a node's processes) mesh: a leading ``dcn_axis``
    over the nodes, trailing axes ``local_axis_names`` of ``local_shape``
    over each node's processes (default: all of them on the first
    trailing axis).  A node's processes are ``LOCAL_WORLD_SIZE`` (set by
    ``torchrun``; without it, every process of the group runs on one
    node).  Ranks are node-major, so the batch split over ('dcn', axis)
    is process-major and contiguous, as ``local_shard_slice``.  A
    ``local_shape`` that does not hold a node's processes raises
    ValueError."""
    from .mesh import ProcessMesh, make_mesh

    n_proc = process_count()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_proc))
    if n_local < 1 or n_proc % n_local:
        raise ValueError(f"{n_proc} processes do not split into nodes of "
                         f"{n_local}")
    if local_shape is None:
        local_shape = (n_local,) + (1,) * (len(local_axis_names) - 1)
    if int(np.prod(local_shape)) != n_local:
        raise ValueError(f"local_shape {tuple(local_shape)} != "
                         f"{n_local} processes per node")
    names = (dcn_axis,) + tuple(local_axis_names)
    shape = (n_proc // n_local,) + tuple(local_shape)
    if n_proc == 1:
        return make_mesh(1, names, shape, device=device)
    return ProcessMesh(resolve_device(device), names, shape)


def global_array_from_local(mesh, local_data, axis: str = "dp",
                            global_shape=None):
    """This process's contiguous block of a global batch (rows
    ``batch_sharding(mesh, axis).rows(N)``; process-local loading), as the
    port's sharded tensor: checked against the global shape and put on
    the mesh's device.  The global shape defaults to the local rows times
    the shard count of the batch axes.  Trees map leaf-wise;
    ``global_shape`` therefore only makes sense for a single-leaf input
    (call per leaf otherwise)."""
    from torch.utils import _pytree

    from .mesh import batch_sharding

    if global_shape is not None and \
            len(_pytree.tree_leaves(local_data)) > 1:
        raise ValueError(
            "global_shape applies to every leaf; with a multi-leaf pytree "
            "call per leaf (or omit it to infer per-leaf shapes)")
    k = batch_sharding(mesh, axis).num_shards

    def put(x):
        x = torch.as_tensor(x, device=mesh.device)
        want = (x.shape[0] * k,) + tuple(x.shape[1:])
        if global_shape is not None and tuple(global_shape) != want:
            raise ValueError(f"a local block of {tuple(x.shape)} over "
                             f"{k} shards is a global {want}, not "
                             f"{tuple(global_shape)}")
        return x

    return _pytree.tree_map(put, local_data)


def fetch(x) -> np.ndarray:
    """Host value of a batch sharded over the processes: ``x`` is this
    process's contiguous shard (rows ``local_shard_slice(N)``); every
    process gets the whole (N, ...) array."""
    return all_gather_rows(torch.as_tensor(x)).cpu().numpy()


def _jsonable(v):
    """json.dump ``default`` for sweep rows: numpy scalars and arrays and
    torch tensors via .tolist(); anything else is a loud error (results
    must be JSON rows -- required by both the exchange and
    durability)."""
    if hasattr(v, "tolist"):
        return v.tolist()
    raise TypeError(f"sweep result of type {type(v).__name__} is not "
                    "JSON-serializable; return dicts/lists of numbers")


def _sweep_part_files(checkpoint_path: str):
    import glob

    return sorted(glob.glob(checkpoint_path + ".p*.json"))


def _load_sweep_checkpoint(checkpoint_path: str) -> dict:
    """Union of all per-process part files: {case index: saved result}.
    Error records are dropped -- a resumed sweep RETRIES failed cases
    (only durable successes are skipped)."""
    import json

    done = {}
    for f in _sweep_part_files(checkpoint_path):
        try:
            with open(f) as fh:
                rec = json.load(fh)
        except (OSError, ValueError):  # half-written part from a kill
            continue
        for k, v in rec.items():
            if not (isinstance(v, dict) and "__error__" in v):
                done[int(k)] = v
    return done


def _save_sweep_part(part_file: str, local: dict):
    """Atomic (tmp+rename) write so a mid-save kill never corrupts a
    previously durable part file.  Never raises -- a failed intermediate
    save (unserializable row, full disk) must not crash one process
    before its peers reach the exchange; the final exchange's own
    serialization check reports the bad row uniformly."""
    import json
    import warnings

    try:
        tmp = part_file + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({str(k): v for k, v in local.items()}, fh,
                      default=_jsonable)
        os.replace(tmp, part_file)
    except Exception as e:  # noqa: BLE001 -- durability is best-effort
        warnings.warn(f"sweep checkpoint save failed ({e!r}); continuing "
                      "without durability for this interval", RuntimeWarning)


def sweep_over_processes(fn, cases: Sequence, allgather: bool = True,
                         return_exceptions: bool = False,
                         checkpoint_path: Optional[str] = None,
                         save_interval_s: float = 60.0):
    """Process-sharded parameter study: process p runs cases ``p, p+P,
    p+2P, ...`` (round-robin), then the results are exchanged
    (``all_gather_object``) so that every process returns the full list.

    A case that raises is captured (never propagated before the exchange
    -- an uncaught exception in one process would leave its peers blocked
    in the collective).  After the exchange, failures raise a
    RuntimeError uniformly on EVERY process, or -- with
    ``return_exceptions=True`` -- are returned in place as
    ``{"__error__": repr}`` records.

    ``checkpoint_path``: durability for long sweeps.  Each process
    persists its completed cases to ``{checkpoint_path}.p{rank}.json``
    (atomic tmp+rename) at most every ``save_interval_s`` seconds and
    once at the end.  A killed sweep resumes by re-running with the same
    path: every process loads the union of ALL part files (shared
    filesystem) and skips cases with a durable result, however case
    ownership moved if the process count changed.  Failed cases are
    retried on resume.  Results must be JSON rows; with a checkpoint (and
    across processes) they come back decoded from JSON on every path, so
    fresh and resumed results have the same types.
    """
    import json
    import time

    p, P_ = process_index(), process_count()
    done = {}
    part_file = None
    if checkpoint_path is not None:
        done = _load_sweep_checkpoint(checkpoint_path)
        part_file = f"{checkpoint_path}.p{p}.json"
    local = {}
    n_new, last_save = 0, time.time()
    for i in range(p, len(cases), P_):
        if i in done:
            local[i] = done[i]
            continue
        try:
            local[i] = fn(cases[i])
        except Exception as e:  # noqa: BLE001 -- kept aligned across ranks
            local[i] = {"__error__": f"case {i}: {e!r}"}
        n_new += 1
        if part_file is not None \
                and time.time() - last_save >= save_interval_s:
            _save_sweep_part(part_file, local)
            last_save = time.time()
    if part_file is not None and n_new:
        _save_sweep_part(part_file, local)

    def _finish(out):
        errors = [v["__error__"] for v in out
                  if isinstance(v, dict) and "__error__" in v]
        if errors and not return_exceptions:
            raise RuntimeError("sweep_over_processes case failures:\n  "
                               + "\n  ".join(errors))
        return out

    if P_ == 1 or not allgather:
        if checkpoint_path is not None:
            # durability implies JSON rows: round-trip fresh results
            # through the encode/decode that resumed ones went through
            for k in list(local):
                try:
                    local[k] = json.loads(
                        json.dumps(local[k], default=_jsonable))
                except TypeError as e:
                    local[k] = {"__error__": f"case {k}: unserializable "
                                             f"result ({e})"}
        return _finish([local.get(i) for i in range(len(cases))])
    try:
        payload = json.dumps({str(k): v for k, v in local.items()},
                             default=_jsonable)
    except TypeError as e:
        # still reach the collective -- peers must not block on our error
        local = {k: {"__error__": f"case {k}: unserializable result "
                                  f"({e})"} for k in local}
        payload = json.dumps({str(k): v for k, v in local.items()})
    payloads = [None] * P_
    dist.all_gather_object(payloads, payload)
    out = [None] * len(cases)
    for rec in payloads:
        for k, v in json.loads(rec).items():
            out[int(k)] = v
    return _finish(out)
