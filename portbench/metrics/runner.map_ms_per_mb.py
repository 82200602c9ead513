"""The map stages' wall (``em.stats()["stages"]``, kind ``map``), summed
over the window's jobs, in ms per MB of corpus."""

LAYER = "runner"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    secs = sum(s.get("seconds", 0.0) for j in ctx.jobs
               for s in j["stats"].get("stages", ()) if s.get("kind") == "map")
    return 1e3 * secs / (ctx.total_bytes / 1e6)
