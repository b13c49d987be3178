"""Wall-clock timing utilities.

The port's own copy of ``generative_physics_informed_pde_tpu/utils/
time.py``.  Re-implementation of ``StopWatch`` / ``Timer``
(reference: utils/time.py:6-105): simple stopwatch plus a run timer with
remaining-runtime (RRT/ETA) projection and named-thread accounting.

Both read the host's wall clock and never synchronise a device: CUDA
work is asynchronous, so a caller timing the card synchronises first (or
moves the result to the host, as ``tensor.cpu()`` does) before
``stop()`` / ``exit()``; otherwise the time is that of the enqueue.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Optional


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
