"""Device milliseconds per sweep of every kernel that is not K1 (the
written-out V-cycle and PCG updates, the QOI and the moments), from the
traced sweeps."""


def read(ctx):
    t = ctx.traced
    if not t or not t["kernels"]:
        return None
    k1 = ctx.counters["k1_name"]
    other = sum(s for name, s, _ in t["kernels"] if k1 not in name)
    return 1e3 * other / t["iterations"]
