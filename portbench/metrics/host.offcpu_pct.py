"""The share of the host's traced work during which its thread was off
the CPU: over the self time of every span (``em.stats()["spans"]``: a
span less its children on the same thread), 100 x (self wall - self
thread CPU) / self wall, summed over the window's jobs.  Left out: the
``stage`` spans, which cover everything, and the declared waits
(``stall``, ``io_wait``, ``spill_queue``).  What is left waited for the
interpreter lock, another lock, a core or the card."""

LAYER = "pipeline"
UNIT = "%"
BETTER = "lower"
MOVES = "host_mem_peak_mb"

SKIP = ("stage", "stall", "io_wait", "spill_queue")


def read(ctx):
    wall = cpu = 0.0
    for j in ctx.jobs:
        for cat, s in (j["stats"].get("spans") or {}).items():
            if cat in SKIP or "self_cpu_seconds" not in s:
                continue
            wall += s["self_seconds"]
            cpu += s["self_cpu_seconds"]
    return 100.0 * (wall - cpu) / wall if wall > 0 else None
