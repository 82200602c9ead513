"""Live dashboard over the per-rank ``/metrics`` endpoints.

Port of ``dampr_tpu/obs/top.py``, whole.  The metrics endpoint
(:mod:`.serve`) exposes a run's live registry; this module is its
consumer, a stdlib-only terminal view that polls each rank's
``/metrics`` and ``/healthz`` and renders one row per rank: the run and
its stage, jobs, the writer queue and bytes in flight, store residency
and spill, overlap slots, and MB/s derived from successive scrapes.  On
one card the port runs one rank; the layout is the JAX package's, so
one dashboard reads both.

- every request has a hard timeout (bounded by the refresh interval): a
  wedged rank never hangs the dashboard;
- a rank that stops answering renders as a ``DEAD`` row within one
  refresh;
- ``--once`` (with ``--json``) takes one snapshot and exits, with no
  terminal control codes;
- ``--jobs URL`` adds the serve daemon's job table (:mod:`..serve`).

Rank k serves on ``base_port + k`` (``--port``, default
``settings.metrics_port``); ``--ports`` takes an explicit list.
"""

import json
import sys
import time

from .. import settings

#: Flattened exposition names -> row fields (see .promtext.sanitize).
_GAUGES = {
    "dampr_tpu_run_stage": "stage",
    "dampr_tpu_run_active_jobs": "active_jobs",
    "dampr_tpu_run_jobs_done": "jobs_done",
    "dampr_tpu_run_jobs_started": "jobs_started",
    "dampr_tpu_writer_queue_depth": "queue_depth",
    "dampr_tpu_writer_inflight_bytes": "inflight_bytes",
    "dampr_tpu_store_resident_bytes": "resident_bytes",
    "dampr_tpu_store_spilled_bytes": "spilled_bytes",
    "dampr_tpu_store_bytes": "store_bytes",
    "dampr_tpu_overlap_live_slots": "overlap_live",
    "dampr_tpu_overlap_stalled_slots": "overlap_stalled",
}
_COUNTERS = {
    "dampr_tpu_mitigation_engagements_total": "mitigation_engagements",
    "dampr_tpu_mitigation_speculative_wins_total": "speculative_wins",
}


def parse_exposition(text):
    """Prometheus text format -> ``{metric_name: value}`` (labels
    dropped — one scrape is one rank, so samples are unambiguous).
    Tolerant: malformed lines are skipped, never fatal."""
    out = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{labels} value   |   name value
        head, _, tail = line.rpartition(" ")
        if not head:
            continue
        name = head.split("{", 1)[0].strip()
        try:
            out[name] = float(tail)
        except ValueError:
            continue
    return out


def _fetch(url, timeout):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


def scrape(port, timeout=1.0, host="127.0.0.1"):
    """One rank's snapshot: ``{port, alive, health, metrics}``.  A rank
    that refuses/timeouts/errors is ``alive=False`` — never a raise,
    never a hang past ``timeout`` per request."""
    base = "http://{}:{}".format(host, port)
    try:
        health = json.loads(_fetch(base + "/healthz", timeout))
        metrics = parse_exposition(_fetch(base + "/metrics", timeout))
    except Exception:
        return {"port": port, "alive": False, "health": None,
                "metrics": {}}
    return {"port": port, "alive": True, "health": health,
            "metrics": metrics}


def _row_from_scrape(rank, snap, prev=None, dt=None):
    """One dashboard row.  ``prev``/``dt`` (the last row + seconds since)
    derive the MB/s rate from the store-bytes counter movement."""
    row = {"rank": rank, "port": snap["port"], "alive": snap["alive"]}
    if not snap["alive"]:
        return row
    health = snap.get("health") or {}
    row["run"] = health.get("run")
    row["metrics_live"] = health.get("metrics_live")
    m = snap["metrics"]
    for name, field in _GAUGES.items():
        if name in m:
            row[field] = m[name]
    for name, field in _COUNTERS.items():
        if name in m:
            row[field] = m[name]
    if (prev is not None and dt and dt > 0
            and isinstance(prev.get("store_bytes"), float)
            and isinstance(row.get("store_bytes"), float)):
        delta = row["store_bytes"] - prev["store_bytes"]
        if delta >= 0:
            row["mbps"] = round(delta / 1e6 / dt, 2)
    return row


def resolve_ports(base_port=None, ranks=None, ports=None, timeout=1.0):
    """The port list to poll.  Explicit ``ports`` wins; otherwise rank k
    maps to ``base_port + k``, with the rank count taken from ``ranks``
    or asked of rank 0's /healthz (falling back to 1 when it's down —
    the dashboard still renders the hole)."""
    if ports:
        return list(ports)
    base = settings.metrics_port if base_port is None else base_port
    if base <= 0:
        return []
    n = ranks
    if not n:
        snap = scrape(base, timeout=timeout)
        n = ((snap.get("health") or {}).get("num_processes")
             if snap["alive"] else None) or 1
    return [base + k for k in range(int(n))]


def snapshot(ports, prev_rows=None, dt=None, timeout=1.0):
    """Scrape every port -> ordered row list (rank = list index)."""
    rows = []
    for rank, port in enumerate(ports):
        prev = None
        if prev_rows and rank < len(prev_rows):
            prev = prev_rows[rank]
        rows.append(_row_from_scrape(rank, scrape(port, timeout=timeout),
                                     prev=prev, dt=dt))
    return rows


# -- rendering --------------------------------------------------------------

_COLS = (
    ("rank", "RANK", 4), ("state", "STATE", 5), ("run", "RUN", 16),
    ("stage", "STG", 3), ("jobs", "JOBS", 9), ("queue_depth", "WQ", 4),
    ("inflight", "INFL", 7), ("resident", "RES", 7),
    ("spilled", "SPILL", 7), ("overlap", "OVLP", 5),
    ("mitigation", "MIT", 4), ("mbps", "MB/S", 8),
)


def _mb(v):
    if not isinstance(v, (int, float)):
        return "-"
    return "{:.0f}M".format(v / 1e6) if v >= 1e6 else "{:.0f}K".format(
        v / 1e3) if v >= 1e3 else "{:.0f}".format(v)


def _cell(row, key):
    if key == "rank":
        return str(row.get("rank", "?"))
    if key == "state":
        return "UP" if row.get("alive") else "DEAD"
    if not row.get("alive"):
        return "-"
    if key == "run":
        return str(row.get("run") or "-")[:16]
    if key == "stage":
        v = row.get("stage")
        return "{:.0f}".format(v) if isinstance(v, float) else "-"
    if key == "jobs":
        done, started = row.get("jobs_done"), row.get("jobs_started")
        if isinstance(done, float) and isinstance(started, float):
            return "{:.0f}/{:.0f}".format(done, started)
        return "-"
    if key == "queue_depth":
        v = row.get("queue_depth")
        return "{:.0f}".format(v) if isinstance(v, float) else "-"
    if key == "inflight":
        return _mb(row.get("inflight_bytes"))
    if key == "resident":
        return _mb(row.get("resident_bytes"))
    if key == "spilled":
        return _mb(row.get("spilled_bytes"))
    if key == "overlap":
        live, stalled = row.get("overlap_live"), row.get("overlap_stalled")
        if isinstance(live, float):
            return "{:.0f}/{:.0f}".format(
                live, stalled if isinstance(stalled, float) else 0)
        return "-"
    if key == "mitigation":
        v = row.get("mitigation_engagements")
        return "{:.0f}".format(v) if isinstance(v, float) else "-"
    if key == "mbps":
        v = row.get("mbps")
        return "{:.2f}".format(v) if isinstance(v, (int, float)) else "-"
    return "-"


def render(rows, color=False):
    """Row dicts -> fixed-width table text (one header + one line per
    rank).  ``color`` adds ANSI: green UP, bold red DEAD."""
    lines = []
    header = "  ".join("{:<{w}}".format(title, w=w)
                       for _, title, w in _COLS)
    lines.append(header)
    for row in rows:
        cells = []
        for key, _, w in _COLS:
            text = "{:<{w}}".format(_cell(row, key), w=w)
            if color and key == "state":
                text = ("\x1b[32m" + text + "\x1b[0m" if row.get("alive")
                        else "\x1b[1;31m" + text + "\x1b[0m")
            cells.append(text)
        lines.append("  ".join(cells))
    return "\n".join(lines)


# -- serve daemon jobs view -------------------------------------------------

_JOB_COLS = (
    ("job", "JOB", 6), ("tenant", "TENANT", 10), ("state", "STATE", 9),
    ("queue_wait_s", "WAIT", 7), ("wall_s", "WALL", 7),
    ("reuse_hits", "REUSE", 5), ("records", "RECS", 7),
    ("coalesced", "COAL", 4), ("error", "ERROR", 24),
)


def scrape_jobs(url, timeout=1.0):
    """One serve daemon's /jobs document, or None when it's down (same
    liveness discipline as rank scrapes: bounded, never a raise)."""
    try:
        return json.loads(_fetch(url.rstrip("/") + "/jobs", timeout))
    except Exception:
        return None


def _job_cell(row, key):
    v = row.get(key)
    if key in ("queue_wait_s", "wall_s"):
        return "{:.2f}s".format(v) if isinstance(v, (int, float)) else "-"
    if key == "error":
        return str(v)[:24] if v else "-"
    if v is None:
        return "-"
    return str(v)


def render_jobs(doc):
    """A /jobs document -> the daemon job table (tenant, state, queue
    wait, reuse hits — the serve-side rows next to the per-rank ones)."""
    if doc is None:
        return "serve daemon: DEAD (no /jobs answer)"
    lines = ["serve daemon {} — {} job(s){}".format(
        doc.get("daemon", "?"), len(doc.get("jobs") or ()),
        " — DRAINING" if doc.get("draining") else "")]
    lines.append("  ".join("{:<{w}}".format(title, w=w)
                           for _, title, w in _JOB_COLS))
    for row in doc.get("jobs") or ():
        lines.append("  ".join(
            "{:<{w}}".format(_job_cell(row, key), w=w)
            for key, _, w in _JOB_COLS))
    tenants = doc.get("tenants") or {}
    if tenants:
        parts = []
        for name, st in sorted(tenants.items()):
            parts.append("{}: {} queued, {}/{} reserved".format(
                name, st.get("queued", 0),
                _mb(st.get("reserved_bytes", 0)),
                _mb(st.get("budget_bytes", 0))))
        lines.append("tenants: " + "; ".join(parts))
    return "\n".join(lines)


def _live_loop(ports, refresh_ms, timeout, jobs_url=None):
    interval = max(0.05, refresh_ms / 1000.0)
    prev_rows, prev_t = None, None
    try:
        while True:
            t0 = time.monotonic()
            dt = (t0 - prev_t) if prev_t is not None else None
            rows = snapshot(ports, prev_rows=prev_rows, dt=dt,
                            timeout=timeout)
            alive = sum(1 for r in rows if r["alive"])
            # Home + clear-to-end each frame (no full clear: less flicker).
            sys.stdout.write("\x1b[H\x1b[J")
            sys.stdout.write(
                "dampr_tpu_torch top — {}/{} rank(s) up — ports {} — "
                "refresh {:.1f}s\n\n".format(
                    alive, len(rows),
                    ",".join(str(p) for p in ports), interval))
            sys.stdout.write(render(rows, color=True) + "\n")
            if jobs_url:
                sys.stdout.write("\n" + render_jobs(
                    scrape_jobs(jobs_url, timeout=timeout)) + "\n")
            sys.stdout.flush()
            prev_rows, prev_t = rows, t0
            time.sleep(max(0.0, interval - (time.monotonic() - t0)))
    except KeyboardInterrupt:
        sys.stdout.write("\n")
        return 0


def main(argv=None):
    """``python -m dampr_tpu_torch.cli top``: the live dashboard over
    the per-rank metrics endpoints.  Exit 0; ``--once`` exits 1 when NO
    rank answered (something to alert on in scripts)."""
    import argparse

    p = argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli top",
        description="live per-rank dashboard over dampr_tpu_torch "
                    "/metrics endpoints")
    p.add_argument("--port", type=int, default=None,
                   help="base metrics port (rank k = port + k; default: "
                        "settings.metrics_port = "
                        "DAMPR_TPU_TORCH_METRICS_PORT)")
    p.add_argument("--ranks", type=int, default=None,
                   help="rank count (default: ask rank 0's /healthz)")
    p.add_argument("--ports", default=None,
                   help="explicit comma-separated port list (overrides "
                        "--port/--ranks; for fallback-shifted ranks)")
    p.add_argument("--refresh", type=int, default=None, metavar="MS",
                   help="refresh interval (default: settings."
                        "top_refresh_ms = DAMPR_TPU_TORCH_TOP_REFRESH_MS)")
    p.add_argument("--timeout", type=float, default=None,
                   help="per-request timeout seconds (default: bounded "
                        "by the refresh interval, max 1s)")
    p.add_argument("--jobs", default=None, metavar="URL",
                   help="also poll a serve daemon (base URL, "
                        "e.g. http://127.0.0.1:9400) and render its job "
                        "table (tenant, state, queue wait, reuse hits) "
                        "below the rank rows")
    p.add_argument("--once", action="store_true",
                   help="one snapshot, no terminal control codes")
    p.add_argument("--json", action="store_true",
                   help="with --once: machine-readable rows")
    args = p.parse_args(argv)

    refresh_ms = (settings.top_refresh_ms if args.refresh is None
                  else args.refresh)
    timeout = args.timeout
    if timeout is None:
        timeout = min(1.0, max(0.1, refresh_ms / 1000.0))
    ports = None
    if args.ports:
        try:
            ports = [int(s) for s in args.ports.split(",") if s.strip()]
        except ValueError:
            p.error("--ports wants a comma-separated integer list")
    ports = resolve_ports(base_port=args.port, ranks=args.ranks,
                          ports=ports, timeout=timeout)
    if not ports and not args.jobs:
        print("no metrics ports to poll: pass --port/--ports, set "
              "DAMPR_TPU_TORCH_METRICS_PORT, or pass --jobs URL",
              file=sys.stderr)
        return 1

    if args.once:
        rows = snapshot(ports, timeout=timeout) if ports else []
        jobs_doc = scrape_jobs(args.jobs, timeout=timeout) \
            if args.jobs else None
        if args.json:
            doc = {"ports": ports, "ranks": rows}
            if args.jobs:
                doc["jobs"] = jobs_doc
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            if ports:
                print(render(rows))
            if args.jobs:
                if ports:
                    print()
                print(render_jobs(jobs_doc))
        alive = any(r["alive"] for r in rows) or jobs_doc is not None
        return 0 if alive else 1

    return _live_loop(ports, refresh_ms, timeout, jobs_url=args.jobs)


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
