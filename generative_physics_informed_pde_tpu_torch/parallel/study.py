"""Futures-compatible execution pools for parameter studies.

The port's counterpart of ``generative_physics_informed_pde_tpu/parallel/
study.py``.  Re-implementation of ``DummyFuture`` / ``DummyProcessPool``
(reference: parallel/utils.py:4-74) plus real parallel backends the
reference only hinted at (its docstring says an external MPI pool was
swapped in):

* ``DummyProcessPool``  -- sequential, exception-capturing (parity),
* ``ThreadPool``        -- concurrent.futures threads; the right backend
  for studies whose cases run on the card (Python only enqueues, the
  device does the work),
* ``sweep_over_devices`` -- a vectorised study function over stacked
  cases, each process of a mesh running its contiguous share of them.
"""

from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor


class DummyFuture:
    """Lazily computes ``f(*args)`` on ``.result()`` with optional
    exception capture (reference: parallel/utils.py:4-46)."""

    def __init__(self, catch_exceptions, f, args, kwargs):
        self._catch_exceptions = catch_exceptions
        self._f = f
        self._args = args
        self._kwargs = kwargs
        self._results = None
        self._exception = None
        # explicit done flag: keying "not yet computed" on _results is
        # None would re-execute (and re-run side effects of) a function
        # that legitimately returns None
        self._done = False

    def compute(self):
        if not self._done:
            try:
                self._results = self._f(*self._args, **self._kwargs)
            except Exception as e:  # noqa: BLE001 - parity with reference
                self._exception = e
            self._done = True
        if not self._catch_exceptions and self._exception is not None:
            raise self._exception

    def result(self):
        self.compute()
        if self._exception is not None:
            raise self._exception
        return self._results

    def done(self) -> bool:
        return True

    def exception(self):
        self.compute()
        return self._exception


class DummyProcessPool:
    """Sequential futures pool (reference: parallel/utils.py:50-74)."""

    def __init__(self, MAXWORKERS=None, catch_exceptions: bool = True):
        if MAXWORKERS is not None:
            warnings.warn("MAXWORKERS argument supplied to Dummy Process "
                          "Pool has no impact")
        self._catch_exceptions = catch_exceptions

    def activate_exceptions(self):
        self._catch_exceptions = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        return False

    def submit(self, f, *args, **kwargs) -> DummyFuture:
        return DummyFuture(self._catch_exceptions, f, args, kwargs)


class _ThreadFuture:
    """Adapter giving a concurrent.futures.Future the DummyFuture duck
    type: with exceptions activated (catch=False), ``exception()`` and
    ``compute()`` RAISE the captured error instead of returning it --
    code written against DummyProcessPool keys error handling on that."""

    def __init__(self, fut, catch: bool):
        self._fut = fut
        self._catch = catch

    def compute(self):
        e = self._fut.exception()  # blocks until done
        if e is not None and not self._catch:
            raise e

    def result(self):
        return self._fut.result()

    def done(self) -> bool:
        return self._fut.done()

    def exception(self):
        e = self._fut.exception()
        if e is not None and not self._catch:
            raise e
        return e


class ThreadPool:
    """concurrent.futures-backed pool with the same duck type.  For JAX
    workloads threads suffice: python only dispatches, XLA executes."""

    def __init__(self, MAXWORKERS: int = 8, catch_exceptions: bool = True):
        self._ex = ThreadPoolExecutor(max_workers=MAXWORKERS)
        self._catch = catch_exceptions

    def activate_exceptions(self):
        self._catch = False

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._ex.shutdown(wait=True)
        return False

    def submit(self, f, *args, **kwargs) -> _ThreadFuture:
        # catch flag bound at submit time, like DummyProcessPool
        return _ThreadFuture(self._ex.submit(f, *args, **kwargs),
                             self._catch)


def sweep_over_devices(fn, case_args, mesh=None, axis: str = "dp"):
    """Vectorised device sweep: ``fn`` maps one case (a pytree of
    tensors) to a pytree of tensors, and runs over the leading case axis
    of ``case_args`` (the stacked cases) under ``torch.func.vmap``, or
    case by case when ``fn`` does something vmap refuses (``.item()``,
    data-dependent control flow).  On a mesh of several processes each
    process runs its contiguous share of the cases (``shard_data_dict``)
    and the outputs are gathered, so that every process returns all of
    them in order.  ``mesh=None``: this process alone, on the device of
    the first case leaf."""
    import torch
    from torch.utils import _pytree

    from .mesh import gather_batch, make_mesh, shard_data_dict

    leaves = _pytree.tree_leaves(case_args)
    if mesh is None:
        mesh = make_mesh(1, device=torch.as_tensor(leaves[0]).device)
    n = len(leaves[0])
    local = shard_data_dict(case_args, mesh, axis)
    try:
        out = torch.func.vmap(fn)(local)
    except RuntimeError as e:
        # vmap refuses .item() and data-dependent control flow with its
        # own "vmap: ..." error; anything else (out of memory, a failed
        # launch) propagates
        if not str(e).startswith("vmap:"):
            raise
        n_local = len(_pytree.tree_leaves(local)[0])
        outs = [fn(_pytree.tree_map(lambda x, i=i: x[i], local))
                for i in range(n_local)]
        out = _pytree.tree_map(lambda *xs: torch.stack(xs), *outs)
    if len(_pytree.tree_leaves(local)[0]) != n:
        out = _pytree.tree_map(lambda x: gather_batch(x, mesh, axis), out)
    return out
