"""Device milliseconds per SVI step of the collectives on rank 0: every
nccl kernel in the traced steps (the gradient and log all-reduces and
the BatchNorm statistics' sums over the ranks)."""


def read(ctx):
    t = ctx.traced
    if not ctx.on_card or not t or ctx.world < 2:
        return None
    ms = 1e3 * sum(s for name, s, _ in t["kernels"] if "nccl" in name.lower())
    return ms / t["iterations"] if ms else None
