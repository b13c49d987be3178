"""Device milliseconds per SVI step of the convolutions, forward and
backward: the device time the profiler books under ``aten::convolution``
and ``aten::convolution_backward`` in the traced steps (rank 0 on a
mesh)."""

OPS = ("aten::convolution", "aten::convolution_backward")


def read(ctx):
    t = ctx.traced
    if not ctx.on_card or not t:
        return None
    ms = 1e3 * sum(t["ops"].get(op, 0.0) for op in OPS)
    return ms / t["iterations"] if ms else None
