"""Host milliseconds per pool spent in the PCG's loop bodies, enqueueing
the iteration's work (its V-cycle levels included): the program's
``pcg.iteration`` spans in the traced pools, from its span record
(``span_totals``; spans record only while a profiler does).  The
``pcg.stop_check`` host reads are the loop's condition, outside every
``pcg.iteration`` span, so no wait for the card is in this time."""


def read(ctx):
    t = ctx.traced
    if not t:
        return None
    try:
        from generative_physics_informed_pde_tpu_torch.utils.time import (
            span_totals)
    except ImportError:  # a program without spans
        return None
    s = span_totals().get("pcg.iteration", {}).get("host_s")
    return 1e3 * s / t["iterations"] if s else None
