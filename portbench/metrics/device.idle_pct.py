"""The share of the window in which no operation ran on the card (the
union of the profiler's kernels, copies and memsets)."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    tl = ctx.timeline
    if not tl or tl["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["window_s"])
