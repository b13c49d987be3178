"""Peak device memory allocated in the measured window, in GB
(``torch.cuda.max_memory_allocated`` after ``reset_peak_memory_stats``
at the window's start)."""


def read(ctx):
    peak = ctx.counters.get("window_peak_bytes")
    return peak / 1e9 if peak else None
