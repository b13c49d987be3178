"""Wall-clock timing utilities.

The port's own copy of ``generative_physics_informed_pde_tpu/utils/
time.py``.  Re-implementation of ``StopWatch`` / ``Timer``
(reference: utils/time.py:6-105): simple stopwatch plus a run timer with
remaining-runtime (RRT/ETA) projection and named-thread accounting.

Both read the host's wall clock and never synchronise a device: CUDA
work is asynchronous, so a caller timing the card synchronises first (or
moves the result to the host, as ``tensor.cpu()`` does) before
``stop()`` / ``exit()``; otherwise the time is that of the enqueue.

``span(name)`` marks a layer boundary of the port's hot paths (the solve,
the V-cycle levels, the loader's host work, the SVI step's parts).  It
records only while a ``torch.profiler`` session is recording: then it
enters ``torch.profiler.record_function("gpipde." + name)``, so the
profiler's trace names the range (and every idle gap of the device inside
it) by the port's layer, and keeps a host-clock record in memory, read by
``span_records`` / ``span_totals`` and cleared by ``reset_spans``.  With no
profiler recording, ``span`` returns one shared no-op context.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch


class StopWatch:
    """Accumulating host wall-clock stopwatch; no device sync inside
    (reference: utils/time.py:6-26)."""

    def __init__(self, start: bool = False):
        self._t0 = None
        self._elapsed = 0.0
        if start:
            self.start()

    def start(self):
        self._t0 = time.time()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("StopWatch not started")
        self._elapsed += time.time() - self._t0
        self._t0 = None
        return self._elapsed

    @property
    def elapsed(self) -> float:
        if self._t0 is not None:
            return self._elapsed + (time.time() - self._t0)
        return self._elapsed

    def reset(self):
        self._t0 = None
        self._elapsed = 0.0


def _fmt_seconds(s: float) -> str:
    s = int(s)
    h, rem = divmod(s, 3600)
    m, sec = divmod(rem, 60)
    if h:
        return f"{h}h{m:02d}m{sec:02d}s"
    if m:
        return f"{m}m{sec:02d}s"
    return f"{sec}s"


class Timer:
    """Run timer with ETA projection and named-section accounting, on
    the host's wall clock (reference: utils/time.py:29-105)."""

    def __init__(self, N_total: Optional[int] = None):
        self._N_total = N_total
        self._t_start = time.time()
        self._threads = defaultdict(float)
        self._thread_t0 = {}

    def RRT(self, step: int) -> str:
        """Remaining-runtime estimate after ``step`` of N_total steps."""
        if self._N_total is None or step <= 0:
            return "n/a"
        elapsed = time.time() - self._t_start
        per_step = elapsed / step
        return _fmt_seconds(per_step * (self._N_total - step))

    def ETA(self, step: int) -> str:
        if self._N_total is None or step <= 0:
            return "n/a"
        elapsed = time.time() - self._t_start
        eta = self._t_start + elapsed / step * self._N_total
        return time.strftime("%H:%M:%S", time.localtime(eta))

    # ------------------------------------------------- named accounting
    def enter(self, name: str):
        self._thread_t0[name] = time.time()

    def exit(self, name: str):
        t0 = self._thread_t0.pop(name, None)
        if t0 is not None:
            self._threads[name] += time.time() - t0

    def report(self) -> str:
        total = time.time() - self._t_start
        lines = [f"{'section':<24}{'seconds':>10}{'share':>8}"]
        for name, sec in sorted(self._threads.items(), key=lambda kv: -kv[1]):
            lines.append(f"{name:<24}{sec:>10.2f}{sec / total:>8.1%}")
        lines.append(f"{'TOTAL':<24}{total:>10.2f}{1.0:>8.1%}")
        return "\n".join(lines)


# ------------------------------------------------------------------ spans
class SpanRecord(NamedTuple):
    """One finished span: ``root`` is the id of the outermost span open on
    its thread when it started (shared by every span of one solve, pool or
    step), ``parent`` the id of the span it is nested in (None for a
    root); ``start_ns`` / ``end_ns`` are ``time.perf_counter_ns()``."""

    name: str
    id: int
    root: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    thread: int


_OFF = contextlib.nullcontext()
_records: list = []          # list.append is atomic: spans of any thread
_ids = itertools.count(1)
_local = threading.local()   # each thread's stack of open spans
_profiler_enabled = torch.autograd._profiler_enabled


class _Span:
    __slots__ = ("name", "id", "root", "parent", "t0", "stack", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self.stack = stack
        self.rf = torch.profiler.record_function("gpipde." + self.name)
        self.rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.stack.pop()
        self.rf.__exit__(*exc)
        _records.append(SpanRecord(self.name, self.id, self.root,
                                   self.parent, self.t0, t1,
                                   threading.get_ident()))
        return False


def span(name: str):
    """A context that marks one layer boundary ``name`` while a
    ``torch.profiler`` session records (``torch.autograd.
    _profiler_enabled()``), and does nothing otherwise.  ``name`` is a
    constant (a level's name built once), so the off path formats
    nothing.  The stack of open spans is per thread: a backward that
    autograd runs on its device thread opens a root there."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name)


def span_records() -> list:
    """The spans recorded since the last :func:`reset_spans`, in the
    order they ended."""
    return list(_records)


def span_totals() -> dict:
    """``{name: {"calls", "host_s", "self_s"}}`` over the recorded spans:
    host seconds between entry and exit, and the part of them that no
    child span covers (its own work, and its waits outside any child)."""
    records = list(_records)
    child = defaultdict(int)
    for r in records:
        if r.parent is not None:
            child[r.parent] += r.end_ns - r.start_ns
    out = {}
    for r in records:
        t = out.setdefault(r.name, {"calls": 0, "host_s": 0.0,
                                    "self_s": 0.0})
        dt = r.end_ns - r.start_ns
        t["calls"] += 1
        t["host_s"] += dt / 1e9
        t["self_s"] += (dt - child.get(r.id, 0)) / 1e9
    return out


def reset_spans():
    """Forget every recorded span."""
    _records.clear()
