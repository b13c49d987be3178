"""The benchmark's yardstick: the card's published peaks, the cost of one
stencil apply, kernel timing by CUDA events and the profiler's reading of a
traced window.

Frozen copies, so that a change to the program cannot move them:
``HBM_BYTES_PER_S`` / ``F32_FLOPS_PER_S`` and ``stencil_cost`` come from
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F32_FLOPS_PER_S``,
``STENCIL_GRIDS``, ``stencil_cost``), ``cuda_time_ms`` from
``chip_smoke.py`` ``cuda_time_ms``; :func:`profile_window` extends
``chip_smoke.py`` ``device_profile`` with the busy time as the union of
the device's intervals, per-operator device totals and the idle gaps named
by what the host was doing.  Nothing here imports the program.
"""

from __future__ import annotations

import time

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the full 700 W.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# by the dtype an operation computes in (float32 outside the tensor cores)
PEAK_FLOPS_PER_S = {"float32": F32_FLOPS_PER_S, "float64": 34e12,
                    "bfloat16": 989e12}

STENCIL_GRIDS = {"apply_stencil": 7, "apply_stencil_sym": 4}


def stencil_cost(name, Ny, Nx, B, item):
    """(bytes, bound ms, bound_by) of one K1/K2 apply: each input read
    once (coefficient grids, v, mask), the output written once, and 14 f32
    flops per output (7 mul, 6 add, 1 mask mul)."""
    moved = (STENCIL_GRIDS[name] + 2) * Ny * Nx * B * item + Ny * Nx * item
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 14 * Ny * Nx * B / F32_FLOPS_PER_S * 1e3
    return moved, max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                        else "operations")


def cuda_time_ms(fn, reps: int, flush=None) -> float:
    """Mean device time of ``fn`` by CUDA events, after 3 warm-up calls.

    With ``flush`` (a tensor larger than the 50 MB L2, zeroed, or a
    function that reads one) each call is timed alone, after the L2 cache
    was overwritten outside the timed interval, so it reads from HBM; a
    device-side sleep after the flush lets the host enqueue the timed call
    before the device reaches it, so a slow host's launch overhead is not
    in the time.  Without, ``reps`` calls run back to back behind such a
    sleep."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(50_000_000)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        flush() if callable(flush) else flush.zero_()
        torch.cuda._sleep(200_000)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / reps


def _union_seconds(intervals):
    """Length of the union of (start, end) intervals, in their unit."""
    total, hi = 0.0, None
    for a, b in sorted(intervals):
        if hi is None or a > hi:
            total += b - a
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def _gaps(intervals, lo, hi):
    """The idle (start, end) stretches of [lo, hi] outside ``intervals``."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        out.append((cur, hi))
    return out


NAMED_GAPS = 400


def profile_window(fn, cuda: bool = True):
    """Run ``fn`` once under ``torch.profiler`` and read the trace (with
    ``cuda=False``, of the host alone: no device interval is read).

    Returns a dict: ``window_s`` (host clock, the call and a synchronize),
    ``busy_s`` (the union of the device's kernel, copy and set intervals),
    ``kernels`` ([(name, seconds, calls)], largest first), ``ops`` ({host
    operator: device seconds of the kernels it launched, children
    included}) and ``idle`` ([(host op, seconds)]: the longest stretches
    in which the device ran nothing, each named by the innermost host
    operator running at its middle, summed by name, largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        window = time.perf_counter() - t0
    kernels, dev, host = {}, [], []
    for ev in prof.events():
        tr = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False):
                continue  # ranges that overlap the kernels they contain
            s, n = kernels.get(ev.name, (0.0, 0))
            kernels[ev.name] = (s + (tr.end - tr.start) / 1e6, n + 1)
            dev.append((tr.start, tr.end))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, ev.name))
    ops = {}
    for ka in prof.key_averages():
        t = getattr(ka, "device_time_total", None)
        if t is None:
            t = getattr(ka, "cuda_time_total", 0.0)
        if t:
            ops[ka.key] = ops.get(ka.key, 0.0) + t / 1e6
    busy = _union_seconds(dev) / 1e6
    idle = {}
    if dev:
        import numpy as np

        lo = min(a for a, _ in dev)
        hi = max(b for _, b in dev)
        gaps = sorted(_gaps(dev, lo, hi), key=lambda g: g[0] - g[1])
        hs = np.array([h[0] for h in host], dtype=np.float64)
        he = np.array([h[1] for h in host], dtype=np.float64)
        # the longest gaps are named one by one; the rest are summed
        for a, b in gaps[:NAMED_GAPS]:
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            name = (host[cover[np.argmin(he[cover] - hs[cover])]][2]
                    if cover.size else "(no host operator)")
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
        rest = sum(b - a for a, b in gaps[NAMED_GAPS:]) / 1e6
        if rest:
            idle["(shorter gaps)"] = rest
        # host time before the first and after the last device interval
        idle["(window edges)"] = max(0.0, window - (hi - lo) / 1e6)
    return {"window_s": window, "busy_s": min(busy, window),
            "kernels": sorted(((k, s, n) for k, (s, n) in kernels.items()),
                              key=lambda r: -r[1]),
            "ops": ops,
            "idle": sorted(idle.items(), key=lambda r: -r[1])}
