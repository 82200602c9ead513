"""Thread CPU seconds of the per-record operators (``settings.profile``'s
per-op ``cpu_seconds``, the keyed ``combine`` left out), summed over the
window's jobs, in ms per MB of corpus: the on-CPU part of
``record_ops.ms_per_mb``, read at the same sites."""

LAYER = "record ops"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    secs, seen = 0.0, False
    for j in ctx.jobs:
        for stage in (j["stats"].get("profile") or {}).get("stages", ()):
            for op in stage.get("ops", ()):
                if op.get("op") != "combine" and "cpu_seconds" in op:
                    secs += op["cpu_seconds"]
                    seen = True
    return 1e3 * secs / (ctx.total_bytes / 1e6) if seen else None
