"""PCG iterations of a label dispatch, averaged over the window's
dispatches: the loader's ``label_iterations`` counter, read after each
pool."""


def read(ctx):
    its = ctx.counters.get("pcg_iterations")
    return sum(its) / len(its) if its else None
