"""Structured, run-scoped log stream: coded JSONL events for postmortems.

The engine's operational warnings used to be stdlib ``log.warning`` text
scattered across modules — grep-able by a human, useless to tooling.
This module gives every such site a **coded, structured** record::

    {"ts": ..., "level": "warn", "rank": 0, "run": "bench-tfidf",
     "stage": 3, "code": "writer-pool-stuck", "msg": "...", "data": {...}}

appended to ``<run>/trace/events.jsonl`` (one ``O_APPEND`` write per
line — a run that dies mid-write corrupts at most its own line; tolerant
line-validated reads; bounded at :data:`EVENTS_MAX` lines via tmp +
atomic-rename compaction).  The same records, JAX package's codes and
layout, ride the flight recorder into ``crashdump.json`` (WARN+ tail).

Design constraints, in the tracer's order:

1. **Near-zero cost off.**  With no active stream, :func:`debug` /
   :func:`info` are one module-global load + ``None`` check;
   :func:`warn` / :func:`error` additionally forward to the stdlib
   logger they always reached (the pre-existing behavior of the
   migrated sites), so nothing is ever silenced by the stream being off.
2. **Closed event-code registry.**  Every code passed to an emit call in
   the package source is declared in :data:`EVENT_CODES`, with the JAX
   package's meaning (``docs/observability.md`` documents them).  Tooling
   can match on codes; message text stays free to improve.
3. **Crash-visible.**  WARN+ records mirror into the flight recorder's
   bounded log tail (when one is attached), so ``crashdump.json``
   carries the last operational events even for a run that never
   streamed to disk.

Scope: the active stream is process-global (runs own it run-scoped via
``start``/``stop``), the same nesting contract as the tracer.
"""

import json
import logging
import os
import threading
import time

_stdlog = logging.getLogger("dampr_tpu_torch.obs.log")

FILE = "events.jsonl"

#: Lines ``events.jsonl`` keeps; past it the file is compacted to the
#: newest.  0 writes no file (WARN+ still mirrors into the flight
#: recorder).
EVENTS_MAX = 4096

#: Leveled severities, stdlib-aligned.
LEVELS = {"debug": 10, "info": 20, "warn": 30, "error": 40}

#: Closed registry of structured event codes: ``code -> one-line
#: meaning``, the JAX package's codes that the port emits.  Codes are
#: stable tool-facing identifiers — never rename one that shipped.
EVENT_CODES = {
    # -- lifecycle -----------------------------------------------------------
    "run-start": "a run began executing under this name",
    "run-finish": "a run finalized cleanly (wall seconds in data)",
    "run-failed": "a run died; the flight recorder flushes its crashdump",
    # -- shutdown thread joins -----------------------------------------------
    "writer-pool-stuck": "a spill writer thread failed to join at close "
                         "(daemon abandoned; wedged codec or disk write)",
    "overlap-producer-stuck": "an overlapped codec producer thread failed "
                              "to join at shutdown",
    "early-fold-stuck": "the early-fold worker failed to drain at stage "
                        "end; unfolded mappings used",
    # -- degraded execution paths --------------------------------------------
    "early-fold-error": "an early-fold attempt raised; folding disabled "
                        "for the stage (originals kept)",
    "codec-fallback": "a configured compression codec is unavailable; "
                      "encoding fell down the zstd->lz4->zlib ladder",
    # -- straggler mitigation ------------------------------------------------
    "mitigation-engaged": "skew mitigation engaged: collective exchanges "
                          "degrade in place",
    "mitigation-disengaged": "skew mitigation disengaged after healthy "
                             "probe windows",
    "mitigation-downweight": "a pathological rank's partition share was "
                             "down-weighted for the rest of the run",
    "mitigation-unsafe-skip": "mitigation engaged but window skipping is "
                              "disabled (exchange watchdog off)",
    # -- metrics endpoint ----------------------------------------------------
    "metrics-port-fallback": "the per-rank /metrics port was taken; the "
                             "endpoint bound the next free port",
    "metrics-bind-failed": "no /metrics port could be bound; the endpoint "
                           "is disabled for this run",
    # -- telemetry plane -----------------------------------------------------
    "sentry-regression": "the regression sentry flagged a metric against "
                         "its per-fingerprint baseline window",
    # -- serve daemon (dampr_tpu_torch.serve) --------------------------------
    "serve-submit": "the serve daemon received a submission from a tenant",
    "serve-admit": "a submission passed the admission gate and reserved "
                   "its byte cost against the tenant budget",
    "serve-reject": "a submission was refused at the door (wire error, "
                    "validation failure, budget, queue depth, or drain)",
    "serve-coalesce": "an identical in-flight fingerprint: the submission "
                      "attached as a follower of the running primary",
    "serve-evict": "retired job records past the retention bound were "
                   "evicted from the daemon's job table",
    "serve-drain": "the daemon began draining: finishing admitted jobs, "
                   "rejecting new submissions",
}


class LogStream(object):
    """One run's structured event stream.

    ``path=None`` runs the stream in recorder-only mode: nothing lands
    on disk, but WARN+ records still mirror into the attached flight
    recorder's log tail (how an untraced-but-metered run gets a crash
    log tail without paying file IO per event).
    """

    def __init__(self, run_name, rank=0, level="info", path=None,
                 recorder=None, capacity=None):
        self.run = run_name
        self.rank = int(rank or 0)
        self.min_level = LEVELS.get(str(level).lower(), LEVELS["info"])
        self.path = path
        self.recorder = recorder
        self.capacity = (EVENTS_MAX if capacity is None
                         else int(capacity))
        if self.capacity <= 0:
            self.path = None  # bound of 0 = no on-disk stream
        self.counts = {}      # level name -> records accepted
        self.dropped = 0      # records lost to append failures
        self._appends = 0     # appends since the last compaction check
        self._lock = threading.Lock()

    # -- record path ---------------------------------------------------------
    def emit(self, level, code, msg, stage=None, data=None):
        """Append one structured record (best-effort: a failing event
        log must never fail the run it describes).  Returns the record
        dict, or None when the level is below the stream's floor."""
        lvl = LEVELS.get(level, LEVELS["info"])
        rec = None
        if lvl >= self.min_level:
            rec = {
                "ts": round(time.time(), 3),
                "level": level,
                "rank": self.rank,
                "run": self.run,
                "stage": stage,
                "code": code,
                "msg": msg,
            }
            if data:
                rec["data"] = data
            self.counts[level] = self.counts.get(level, 0) + 1
            if self.path is not None:
                self._append(rec)
        if lvl >= LEVELS["warn"]:
            rec_mirror = rec
            if rec_mirror is None:
                # Level floor above warn never happens (error > warn),
                # but a stream floored at "error" must still mirror the
                # warn into the crash tail — build the record for the
                # ring only.
                rec_mirror = {"ts": round(time.time(), 3), "level": level,
                              "rank": self.rank, "run": self.run,
                              "stage": stage, "code": code, "msg": msg}
                if data:
                    rec_mirror["data"] = data
            recorder = self.recorder
            if recorder is not None:
                recorder.record_log(rec_mirror)
        return rec

    def _append(self, rec):
        try:
            line = json.dumps(rec, sort_keys=True,
                              separators=(",", ":"), default=str)
            if "\n" in line:   # a pathological repr leaked a newline:
                self.dropped += 1  # refuse to corrupt the line index
                return
            with self._lock:
                fd = os.open(self.path,
                             os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
                try:
                    os.write(fd, (line + "\n").encode("utf-8"))
                finally:
                    os.close(fd)
                self._appends += 1
                # Compaction check is a whole-file read: amortize it.
                if self._appends >= max(64, self.capacity // 8):
                    self._appends = 0
                    self._compact_if_over()
        except Exception:
            self.dropped += 1

    def _compact_if_over(self):
        """Keep the newest ``capacity`` valid lines (tmp + atomic
        replace; called under the stream lock)."""
        try:
            with open(self.path, "r", encoding="utf-8",
                      errors="replace") as f:
                lines = f.readlines()
        except OSError:
            return
        if len(lines) <= self.capacity:
            return
        keep = [ln for ln in lines
                if valid_line(ln) is not None][-self.capacity:]
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(keep)
        os.replace(tmp, self.path)

    # -- summary -------------------------------------------------------------
    def summary(self):
        """The ``stats()["log"]`` section."""
        out = {"level": {v: k for k, v in LEVELS.items()}[self.min_level],
               "counts": dict(sorted(self.counts.items())),
               "records": sum(self.counts.values())}
        if self.path is not None:
            out["file"] = self.path
        if self.dropped:
            out["dropped"] = self.dropped
        return out


# -- reading back ------------------------------------------------------------

def valid_line(line):
    """Parse one events.jsonl line, or None (tolerant reads: corruption
    degrades to fewer events, never a raise)."""
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict) or not isinstance(rec.get("code"), str):
        return None
    if rec.get("level") not in LEVELS:
        return None
    return rec


def stream_path(run_name):
    """Where a run's event stream lives (next to trace.json)."""
    from . import export as _export

    return os.path.join(_export.run_trace_dir(run_name), FILE)


def tail(run_or_path, n=20, min_level=None):
    """The last ``n`` valid records of a run's event stream (optionally
    floored at ``min_level``), oldest -> newest.  Never raises."""
    path = run_or_path
    if not os.path.isfile(path):
        path = stream_path(run_or_path)
    if not os.path.isfile(path):
        return []
    floor = LEVELS.get(min_level, 0) if min_level else 0
    out = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                rec = valid_line(line)
                if rec is not None and LEVELS[rec["level"]] >= floor:
                    out.append(rec)
    except OSError:
        return []
    return out[-n:] if n else out


def format_tail(records):
    """Human-readable event-tail lines."""
    if not records:
        return "no structured log events (enable with DAMPR_TPU_TORCH_LOG=info)"
    lines = []
    for rec in records:
        t = time.strftime("%H:%M:%S", time.localtime(rec.get("ts", 0)))
        stage = rec.get("stage")
        lines.append("{} {:<5} r{}{} [{}] {}".format(
            t, rec.get("level", "?").upper(), rec.get("rank", 0),
            " s{}".format(stage) if stage is not None else "",
            rec.get("code", "?"), rec.get("msg", "")))
    return "\n".join(lines)


# -- module-level API (the instrumentation surface) --------------------------

#: The active stream or None.  Read unlocked on the hot path; start/stop
#: mutate under _lock (same contract as trace._active).
_active = None
_lock = threading.Lock()


def start(stream):
    global _active
    with _lock:
        _active = stream


def stop(stream):
    global _active
    with _lock:
        if _active is stream:
            _active = None


def active():
    return _active


def enabled():
    return _active is not None


def _render(msg, args):
    if not args:
        return msg
    try:
        return msg % args
    except (TypeError, ValueError):
        return msg


def debug(code, msg, *args, **kw):
    """Debug-level structured event.  One None-check when no stream is
    active — safe on hot paths."""
    s = _active
    if s is None:
        return
    s.emit("debug", code, _render(msg, args),
           stage=kw.pop("stage", None), data=kw or None)


def info(code, msg, *args, **kw):
    s = _active
    if s is None:
        return
    s.emit("info", code, _render(msg, args),
           stage=kw.pop("stage", None), data=kw or None)


def warn(code, msg, *args, **kw):
    """Warn-level event: ALWAYS reaches the stdlib logger (``logger=``
    names the emitting module's logger so existing log routing and
    capture keep working), plus the structured stream when active."""
    logger = kw.pop("logger", None) or _stdlog
    exc_info = kw.pop("exc_info", False)
    logger.warning(msg, *args, exc_info=exc_info)
    s = _active
    if s is None:
        return
    s.emit("warn", code, _render(msg, args),
           stage=kw.pop("stage", None), data=kw or None)


def error(code, msg, *args, **kw):
    logger = kw.pop("logger", None) or _stdlog
    exc_info = kw.pop("exc_info", False)
    logger.error(msg, *args, exc_info=exc_info)
    s = _active
    if s is None:
        return
    s.emit("error", code, _render(msg, args),
           stage=kw.pop("stage", None), data=kw or None)
