"""Share of the traced window in which the device ran nothing, in
percent: the window's host-clock length less the union of the device's
kernel and copy intervals, from the profiler's trace."""


def read(ctx):
    t = ctx.traced
    if not ctx.on_card or not t or not t["window_s"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
