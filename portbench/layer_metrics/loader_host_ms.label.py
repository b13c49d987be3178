"""Host milliseconds per pool of the loader's own work: the program's
``loader.bce`` (content hash, BCE draw), ``loader.prepare`` (``X_DG``, the
label array, per dispatch ``exp``, the tail padding and the copy to the
card) and ``loader.rom_bc`` spans in the traced pools, from the
program's span record (``span_totals``; spans record only while a
profiler does, so only the traced window is in it)."""

SPANS = ("loader.bce", "loader.prepare", "loader.rom_bc")


def read(ctx):
    t = ctx.traced
    if not t:
        return None
    try:
        from generative_physics_informed_pde_tpu_torch.utils.time import (
            span_totals)
    except ImportError:  # a program without spans
        return None
    tot = span_totals()
    if not any(s in tot for s in SPANS):
        return None
    s = sum(tot[n]["host_s"] for n in SPANS if n in tot)
    return 1e3 * s / t["iterations"]
