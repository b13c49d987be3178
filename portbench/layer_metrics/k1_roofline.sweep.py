"""K1's share of its roofline at the sweep's finest shape: the HBM bound
of one apply at (n+1, n+1, systems) (``measure.stencil_cost``: every
input read once, the output written once) over its time by CUDA events
with a clean L2, in percent."""

from portbench.measure import stencil_cost


def read(ctx):
    ms = ctx.counters.get("k1_clean_ms")
    if not ms:
        return None
    n = ctx.config["grid"] + 1
    item = 8 if ctx.config["dtype"] == "float64" else 4
    _, bound_ms, _ = stencil_cost("apply_stencil", n, n,
                                  ctx.counters["systems"], item)
    return 100.0 * bound_ms / ms
