"""Seconds in which every live map slot waited on its codec (the overlap
executor's ``devtime`` ``codec_wait``), summed over the window's jobs, in
ms per MB of corpus."""

LAYER = "ingest"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    secs = sum(j["stats"].get("devtime", {}).get("codec_wait", 0.0)
               for j in ctx.jobs)
    return 1e3 * secs / (ctx.total_bytes / 1e6)
