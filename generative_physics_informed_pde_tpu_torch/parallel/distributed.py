"""Multi-process distribution on ``torch.distributed``.

The port's counterpart of ``generative_physics_informed_pde_tpu/parallel/
distributed.py``.  JAX runs one SPMD program over one global mesh; PyTorch
runs one process per device, joined in a process group: every process
runs the same script, ``initialize`` wires the group (gloo on the CPU,
nccl on CUDA), each process works on its contiguous share of a batch
(``local_shard_slice``) and collectives bring the shares together
(``fetch``, ``all_gather_rows``, ``sweep_over_processes``).

Typical use (the same script in every process, under ``torchrun`` or
with explicit wiring):

    from generative_physics_informed_pde_tpu_torch import parallel
    parallel.initialize(device="cpu")      # env-driven under torchrun
    mesh = parallel.make_mesh(device="cpu")

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
               device="cuda") -> bool:
    """Idempotent ``torch.distributed.init_process_group`` wrapper.

    With no arguments it joins the group that the environment describes
    (torchrun's ``WORLD_SIZE`` / ``RANK`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``) whenever any of those signals is set; with none set
    it returns False WITHOUT touching ``torch.distributed``, so a later
    call with explicit arguments still works.  The backend follows
    ``device``: gloo on the CPU, nccl on CUDA (whose process then uses
    card ``LOCAL_RANK``, or ``process_id`` modulo the card count).
    Returns True if the group spans more than one process.

    A half-initialised job raises, never falls back to one process: an
    environment with some of the signals but not all of what ``env://``
    needs, explicit wiring without ``num_processes`` and ``process_id``,
    and a second call whose world size or rank differs from the group
    already up.
    """
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
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, **kw)
    return dist.get_world_size() > 1


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


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) of ``group`` (default: all),
    concatenated along the first axis in rank order, on every process;
    ``x`` itself with one process.  ``x`` lies on the backend's device
    (the CPU for gloo, the process's card for nccl)."""
    if process_count() == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


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
