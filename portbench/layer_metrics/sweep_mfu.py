"""The whole sweep's share of the card's roofline, in percent: the
problem's own bytes (each system's seven fine-grid coefficient grids read
once, its field and its solution) over the HBM bandwidth, against the
window's mean sweep time.  No implementation can move fewer bytes than
these, so a faster sweep of any design shows here."""

from portbench.measure import HBM_BYTES_PER_S


def read(ctx):
    c = ctx.counters
    if not ctx.on_card or not c.get("sweeps"):
        return None
    per_sweep = c["window_s"] / c["sweeps"]
    return 100.0 * c["bytes_per_sweep"] / HBM_BYTES_PER_S / per_sweep
