"""Thread CPU seconds of the keyed batch ops (``em.stats()["device"]
["keyed"][op]["cpu_seconds"]``: the FNV lanes, the sort, the segment
fold), summed over the window's jobs, in ms per MB of corpus: the on-CPU
part of ``keyed.host_ms_per_mb``, read at the same sites."""

LAYER = "keyed batch ops"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    secs, seen = 0.0, False
    for j in ctx.jobs:
        for op in (j["stats"].get("device", {}).get("keyed") or {}).values():
            if "cpu_seconds" in op:
                secs += op["cpu_seconds"]
                seen = True
    return 1e3 * secs / (ctx.total_bytes / 1e6) if seen else None
