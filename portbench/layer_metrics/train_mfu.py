"""The SVI step's share of the card's peak, in percent: the floating-point
operations of one step of the plain reference at the cell's shapes,
counted by dtype (``torch.utils.flop_counter``'s formulas, backward
included), each over the data sheet's peak for its precision (67 TFLOP/s
float32 with TF32 off, 989 bfloat16), against the window's mean step time
per card."""

from portbench.measure import PEAK_FLOPS_PER_S


def read(ctx):
    c = ctx.counters
    flops = c.get("flops_per_step")
    if not ctx.on_card or not flops or not c.get("steps"):
        return None
    ideal = sum(n / PEAK_FLOPS_PER_S[dt] for dt, n in flops.items())
    step_s = c["window_s"] / c["steps"]
    return 100.0 * ideal / c.get("cards", 1) / step_s
