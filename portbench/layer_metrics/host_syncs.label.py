"""Host reads that wait for the card, per pool: the program's
``pcg.stop_check`` spans (one before each dispatch's PCG loop and one
per iteration) and ``loader.readback`` spans (one per dispatch), counted
in the traced pools from its span record (``span_totals``)."""

SPANS = ("pcg.stop_check", "loader.readback")


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
    return sum(tot[n]["calls"] for n in SPANS if n in tot) / t["iterations"]
