"""Bytes copied from the card to the host (``em.stats()["device"]
["d2h_bytes"]``), summed over the window's jobs, in KB per MB of
corpus."""

LAYER = "handoff"
UNIT = "KB/MB"
BETTER = "lower"
MOVES = "host_mem_peak_mb"


def read(ctx):
    got = [j["stats"].get("device", {}).get("d2h_bytes") for j in ctx.jobs]
    got = [g for g in got if g is not None]
    if not got:
        return None
    return (sum(got) / 1e3) / (ctx.total_bytes / 1e6)
