"""Thread CPU seconds of the device sink's phases (``scan``, ``pad``,
``enqueue``, ``wait``, ``decode``; ``em.stats()["device"]
["host_phase_cpu_seconds"]``), summed over the window's jobs, in ms per
MB of corpus: the on-CPU part of ``sink.host_ms_per_mb``, read at the
same sites."""

LAYER = "device sink"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"

PHASES = ("scan", "pad", "enqueue", "wait", "decode")


def read(ctx):
    secs, seen = 0.0, False
    for j in ctx.jobs:
        ph = j["stats"].get("device", {}).get("host_phase_cpu_seconds") or {}
        for p in PHASES:
            if p in ph:
                secs += ph[p]
                seen = True
    return 1e3 * secs / (ctx.total_bytes / 1e6) if seen else None
