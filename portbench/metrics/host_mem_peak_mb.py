"""The process's peak resident set (``ru_maxrss``) at the window's end."""

UNIT = "MB"
BETTER = "lower"


def read(ctx):
    return ctx.maxrss_bytes / 1e6
