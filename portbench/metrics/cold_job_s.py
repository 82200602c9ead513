"""The wall of the first job in a fresh process (set-up's first warm-up
job)."""

LAYER = "set-up"
UNIT = "s"
BETTER = "lower"
MOVES = "setup_s"


def read(ctx):
    return ctx.cold_job_s
