"""PCG iterations of a sweep's batched solve, averaged over the window's
sweeps: the physics' ``last_iterations`` counter, read after each sweep."""


def read(ctx):
    its = ctx.counters.get("pcg_iterations")
    return sum(its) / len(its) if its else None
