"""Host reads that wait for the card, per sweep: the program's
``pcg.stop_check`` spans (one before the PCG loop and one per
iteration), counted in the traced sweeps from its span record
(``span_totals``).  The moments' copy to the host ends each sweep
outside the program's solve and is not counted."""


def read(ctx):
    t = ctx.traced
    if not t:
        return None
    try:
        from generative_physics_informed_pde_tpu_torch.utils.time import (
            span_totals)
    except ImportError:  # a program without spans
        return None
    calls = span_totals().get("pcg.stop_check", {}).get("calls")
    return calls / t["iterations"] if calls else None
