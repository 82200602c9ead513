"""Process start to the window's start: imports, the CUDA context, the
kernels' build or load, and the warm-up job; not the harness's making of
the corpus from the seed, which is timed on a line of its own."""

UNIT = "s"
BETTER = "lower"


def read(ctx):
    return ctx.setup_s
