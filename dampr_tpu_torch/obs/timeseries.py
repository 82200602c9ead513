"""Long-horizon telemetry store: compact per-run metric points.

Port of ``dampr_tpu/obs/timeseries.py``, whole.  The run-history corpus
(:mod:`.history`) keeps rich per-stage records for the adaptive plan;
trending a service over weeks needs something flatter, one small point a
run, keyed by the plan fingerprint so runs of one shape form a series::

    <scratch_root>/<run>/telemetry.jsonl   # next to history.jsonl

Each line is one point (schema ``dampr-tpu-telemetry/1``) holding the
:data:`METRICS` scalars it has a sample of: wall seconds, throughput,
spill, faults, reuse yield, device residency and handoff shares.  The
serve daemon appends one point per finished job under the run name
``serve-<tenant>``, so served tenants trend like any run series.

Durability follows history.jsonl's: one ``O_APPEND`` write per point,
line-validated reads, and a tmp + rename compaction past the retention
bound (``settings.history_entries * 16``).
"""

import json
import logging
import os
import threading

from .. import settings
from . import history as _history

log = logging.getLogger("dampr_tpu_torch.obs.timeseries")

SCHEMA_PREFIX = "dampr-tpu-telemetry/"
SCHEMA_VERSION = 1
SCHEMA = SCHEMA_PREFIX + str(SCHEMA_VERSION)
FILE = "telemetry.jsonl"

#: Trended metrics -> the direction that is BAD for each.  "high" means
#: a value above baseline is a regression (time, spill, faults, skew);
#: "low" means below baseline is (throughput, cache yield, residency).
METRICS = {
    "wall_seconds": "high",
    "mbps": "low",
    "spill_bytes": "high",
    "retries": "high",
    "quarantined": "high",
    "late_ratio": "high",
    "reuse_hit_rate": "low",
    "device_fraction": "low",
    "handoff_fraction": "low",
}

#: How many points one corpus retains before compaction.
def retention_cap():
    return max(0, settings.history_entries) * 16


_append_lock = threading.Lock()


def store_path(run_name):
    """Where a run name's telemetry series lives (next to history.jsonl,
    under the durable scratch root)."""
    safe = str(run_name).replace("/", "_")
    return os.path.join(settings.scratch_root, safe, FILE)


def _put(point, key, value):
    if isinstance(value, bool):
        return
    if isinstance(value, (int, float)):
        point[key] = round(value, 6) if isinstance(value, float) else value


def point_from_summary(summary):
    """One telemetry point from a finalized run summary (the stats.json
    dict), or None when the run has nothing trendable."""
    if not summary.get("run") or not summary.get("stages"):
        return None
    point = {
        "schema": SCHEMA,
        "run": summary.get("run"),
        "ts": summary.get("started_at"),
        "fingerprint": _history.plan_fingerprint(
            (summary.get("plan") or {}).get("stage_shapes") or []),
    }
    _put(point, "wall_seconds", summary.get("wall_seconds"))
    totals = summary.get("totals") or {}
    wall = summary.get("wall_seconds")
    bytes_out = totals.get("bytes_out")
    if isinstance(bytes_out, int) and isinstance(wall, (int, float)) \
            and wall > 0:
        _put(point, "mbps", bytes_out / 1e6 / wall)
    spill = sum(st.get("spill_bytes") or 0
                for st in summary.get("stages") or ()
                if isinstance(st.get("spill_bytes"), int))
    _put(point, "spill_bytes", spill)
    health = _history._health_section(summary)
    for key in ("retries", "quarantined", "late_ratio", "reuse_hit_rate"):
        if key in health:
            _put(point, key, health[key])
    dev = summary.get("device") or {}
    _put(point, "device_fraction", dev.get("device_fraction"))
    hb = dev.get("handoff_bytes")
    if isinstance(hb, int) and isinstance(bytes_out, int) and bytes_out > 0:
        _put(point, "handoff_fraction", min(1.0, hb / float(bytes_out)))
    return point


def point_from_history(rec):
    """One telemetry point from a (upgraded) history corpus record —
    the rebuild path when a corpus predates the telemetry store."""
    if rec.get("rank"):
        return None  # rank-tagged trail, not a run-level sample
    point = {
        "schema": SCHEMA,
        "run": rec.get("run"),
        "ts": rec.get("ts"),
        "fingerprint": rec.get("fingerprint")
        or _history.plan_fingerprint(rec.get("stage_shapes") or []),
    }
    _put(point, "wall_seconds", rec.get("wall_seconds"))
    _put(point, "mbps", (rec.get("throughput") or {}).get("mbps"))
    spill = sum(st.get("spill_bytes") or 0
                for st in rec.get("stages") or ()
                if isinstance(st, dict)
                and isinstance(st.get("spill_bytes"), int))
    _put(point, "spill_bytes", spill)
    for key in ("retries", "quarantined", "late_ratio", "reuse_hit_rate"):
        if key in (rec.get("health") or {}):
            _put(point, key, rec["health"][key])
    _put(point, "device_fraction", rec.get("device_fraction"))
    hb = (rec.get("handoff") or {}).get("bytes")
    bytes_out = (rec.get("throughput") or {}).get("bytes_out")
    if isinstance(hb, int) and isinstance(bytes_out, int) and bytes_out > 0:
        _put(point, "handoff_fraction", min(1.0, hb / float(bytes_out)))
    return point


def append_point(point):
    """Append one point; best-effort (telemetry must never fail a run)
    and bounded.  Returns the store path or None."""
    if retention_cap() <= 0 or not point or not point.get("run"):
        return None
    try:
        line = json.dumps(point, sort_keys=True,
                          separators=(",", ":"), default=str)
        if "\n" in line:
            return None
        path = store_path(point["run"])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with _append_lock:
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                         0o644)
            try:
                os.write(fd, (line + "\n").encode("utf-8"))
            finally:
                os.close(fd)
            _compact_if_over(path)
        return path
    except Exception:
        log.debug("telemetry append failed for %r", point.get("run"),
                  exc_info=True)
        return None


def append_from_summary(summary):
    """Fold one finalized summary into the store (the runner's hook)."""
    return append_point(point_from_summary(summary))


def _compact_if_over(path):
    cap = retention_cap()
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return
    if len(lines) <= cap:
        return
    keep = [ln for ln in lines if _valid_line(ln) is not None][-cap:]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(keep)
    os.replace(tmp, path)


def _valid_line(line):
    line = line.strip()
    if not line:
        return None
    try:
        point = json.loads(line)
    except ValueError:
        return None
    if not isinstance(point, dict):
        return None
    tag = point.get("schema")
    if not isinstance(tag, str) or not tag.startswith(SCHEMA_PREFIX):
        return None
    if not point.get("run") or not point.get("fingerprint"):
        return None
    return point


def load(run_name):
    """Every valid point for a run name, oldest -> newest.  Never
    raises; a missing or corrupt store is an empty series."""
    path = store_path(run_name) if run_name else None
    if not path or not os.path.isfile(path):
        return []
    out = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                point = _valid_line(line)
                if point is not None:
                    out.append(point)
    except OSError:
        return []
    return out


def series(points, fingerprint=None):
    """Group points by plan fingerprint -> ordered list.  With a
    fingerprint, just that one series (possibly empty)."""
    by_fp = {}
    for p in points:
        by_fp.setdefault(p.get("fingerprint"), []).append(p)
    if fingerprint is not None:
        return by_fp.get(fingerprint, [])
    return by_fp


def fold(run_name):
    """Rebuild the telemetry store from the run's history corpus (tmp +
    atomic rename): the migration path for corpora that predate the
    store.  Returns the number of points written."""
    points = [p for p in (point_from_history(r)
                          for r in _history.load(run_name))
              if p is not None]
    cap = retention_cap()
    if cap > 0:
        points = points[-cap:]
    path = store_path(run_name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with _append_lock:
        with open(tmp, "w", encoding="utf-8") as f:
            for p in points:
                f.write(json.dumps(p, sort_keys=True,
                                   separators=(",", ":"), default=str))
                f.write("\n")
        os.replace(tmp, path)
    return len(points)
