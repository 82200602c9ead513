"""Thread CPU seconds of the handoff's ``absorb`` phase
(``em.stats()["device"]["host_phase_cpu_seconds"]``), summed over the
window's jobs, in ms per MB of corpus: the on-CPU part of
``handoff.absorb_ms_per_mb``, read at the same site."""

LAYER = "handoff"
UNIT = "ms/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    secs, seen = 0.0, False
    for j in ctx.jobs:
        ph = j["stats"].get("device", {}).get("host_phase_cpu_seconds") or {}
        if "absorb" in ph:
            secs += ph["absorb"]
            seen = True
    return 1e3 * secs / (ctx.total_bytes / 1e6) if seen else None
