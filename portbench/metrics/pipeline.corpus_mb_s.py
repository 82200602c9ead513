"""Corpus bytes of every whole job in the window over the window's whole
time (MB = 10^6 bytes), in the traced run.  A per-layer metric: the
host's speed swings too far from run to run for an end-to-end bound, and
``host_mem_peak_mb`` is the cell's one other end-to-end metric."""

LAYER = "pipeline"
UNIT = "MB/s"
BETTER = "higher"
MOVES = "host_mem_peak_mb"


def read(ctx):
    return ctx.total_bytes / 1e6 / ctx.window_s
