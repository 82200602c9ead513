"""The lowered fold's compute kernels against the card's HBM roofline.

Numerator: the least time one card needs for the window's lowered-fold
work at its published HBM rate (:mod:`portbench.peaks`), the work counted
by the reference from the corpus (every token's bytes read once, every
distinct token's count written once: ``reference.work``).  Denominator:
the summed device time of every compute kernel the profiler recorded in
the window (copies and memsets left out).  So it reads the same work
whatever implements it."""

LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
MOVES = "host_mem_peak_mb"


def read(ctx):
    tl = ctx.timeline
    if not tl or tl["kernel_s"] <= 0 or ctx.work is None:
        return None
    least_s = ctx.work["bytes"] * len(ctx.jobs) / ctx.hbm_bytes_per_s
    return 100.0 * least_s / tl["kernel_s"]
