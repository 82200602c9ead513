"""Stages the plan lowered onto the card (``em.stats()["device"]
["device_stages"]``), of the window's first job (every job runs one plan;
the harness says so where two differ)."""

LAYER = "DSL + plan"
UNIT = "count"
BETTER = "higher"
MOVES = "host_mem_peak_mb"


def read(ctx):
    if not ctx.jobs:
        return None
    return ctx.jobs[0]["stats"].get("device", {}).get("device_stages")
