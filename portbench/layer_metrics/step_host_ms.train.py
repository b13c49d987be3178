"""Host milliseconds per SVI step inside ``Trainer.step``: the program's
``trainer.step`` spans in the traced steps, from its span record
(``span_totals``; spans record only while a profiler does)."""


def read(ctx):
    t = ctx.traced
    if not t:
        return None
    try:
        from generative_physics_informed_pde_tpu_torch.utils.time import (
            span_totals)
    except ImportError:  # a program without spans
        return None
    s = span_totals().get("trainer.step", {}).get("host_s")
    return 1e3 * s / t["iterations"] if s else None
