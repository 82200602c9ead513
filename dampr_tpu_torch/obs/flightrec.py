"""Flight recorder: a bounded tail of recent spans + metric samples,
flushed to ``crashdump.json`` when a run dies.

The trace/stats artifacts are post-hoc — ``_finalize_obs`` writes them
when the run returns, so a wedged or killed run used to leave *nothing*.
The flight recorder closes that gap: while a run is live, every span the
tracer records and every sample the metrics sampler takes also lands in
a fixed-capacity ring (:data:`RING_EVENTS`); the kill / exception path
(``MTRunner.run``, after the store has aborted its writes and released
its device lanes) flushes the ring to
``<trace_dir>/<run>/trace/crashdump.json``.

The dump IS a Chrome trace-event document — the same schema as
``trace.json`` (``docs/trace_schema.json``; counter samples are
``"ph":"C"`` events), so it loads in Perfetto and validates with
``tools/validate_trace.py`` unchanged.  ``otherData.crash`` carries the
death context: reason, exception type/message, ring occupancy/drops.

The ring is append-only and lock-free on the record path (``deque``
appends are atomic under the GIL; the drop counter is a best-effort
approximation) — recording must never slow the run it exists to
autopsy.  Flushing is idempotent: each call rewrites the dump
atomically, so a later flush with richer context (the runner's
exception handler after ``abort_writes``) simply supersedes the
earlier one.
"""

import collections
import json
import logging
import os
import threading
import time

log = logging.getLogger("dampr_tpu_torch.obs.flightrec")

CRASHDUMP_FILE = "crashdump.json"

#: Ring capacity (events): bounds the crash artifact whatever the run's
#: size.  0 disables the recorder.
RING_EVENTS = 1024

_active = None
_lock = threading.Lock()


class FlightRecorder(object):
    """Bounded ring of recent observability events for one run.

    Entries are ``("span", cat, name, t_abs, dur, lane, lane_name,
    args)`` or ``("sample", t_abs, {series: value})``; ``t_abs`` is an
    absolute ``perf_counter`` timestamp (converted to the recorder's
    epoch at flush, so span and sample clocks always agree in the
    dump)."""

    def __init__(self, run_name, capacity):
        self.run = run_name
        self.capacity = max(1, int(capacity))
        self.epoch = time.perf_counter()
        self.wall_start = time.time()
        self._ring = collections.deque(maxlen=self.capacity)
        #: Bounded tail of structured WARN+ log records (obs.log mirrors
        #: them here), flushed as ``otherData.log`` — a crashdump names
        #: the operational events that preceded the death, not just the
        #: span/sample timeline.
        self._log = collections.deque(maxlen=self.capacity)
        self.drops = 0  # best-effort (unlocked): ring evictions
        self.flush_count = 0
        self.path = None

    # -- record path (hot: no locks) ----------------------------------------
    def record_span(self, cat, name, t_abs, dur, lane, lane_name, args):
        ring = self._ring
        if len(ring) >= self.capacity:
            self.drops += 1
        ring.append(("span", cat, name, t_abs, dur, lane, lane_name,
                     args))

    def record_sample(self, t_abs, vals):
        ring = self._ring
        if len(ring) >= self.capacity:
            self.drops += 1
        ring.append(("sample", t_abs, vals))

    def record_log(self, rec):
        """One structured log record (a dict per docs/trace_schema.json's
        ``otherData.log`` items) into the bounded log tail."""
        self._log.append(rec)

    def __len__(self):
        return len(self._ring)

    # -- flush --------------------------------------------------------------
    def _events(self, snapshot):
        """Ring entries -> Chrome trace events (schema-valid: lanes get
        thread_name metadata, spans are X/i, samples are C counter
        events)."""
        pid = 1
        out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": "dampr_tpu_torch:{} (crashdump)".format(
                    self.run)}}]
        tid_of = {}
        metas = []
        body = []
        for ev in snapshot:
            if ev[0] == "sample":
                _kind, t_abs, vals = ev
                ts = round(max(0.0, t_abs - self.epoch) * 1e6, 3)
                for series, v in sorted(vals.items()):
                    if not isinstance(v, (int, float)) or isinstance(
                            v, bool):
                        continue
                    body.append({"ph": "C", "name": series, "cat": "metric",
                                 "pid": pid, "tid": 0, "ts": ts,
                                 "args": {"value": v}})
                continue
            _kind, cat, name, t_abs, dur, lane, lane_name, args = ev
            tid = tid_of.get(lane)
            if tid is None:
                tid = tid_of[lane] = len(tid_of) + 1
                metas.append({"ph": "M", "pid": pid, "tid": tid,
                              "name": "thread_name",
                              "args": {"name": lane_name or str(lane)}})
            rec = {"name": name, "cat": cat, "pid": pid, "tid": tid,
                   "ts": round(max(0.0, t_abs - self.epoch) * 1e6, 3)}
            if dur is None:
                rec["ph"] = "i"
                rec["s"] = "t"
            else:
                rec["ph"] = "X"
                rec["dur"] = round(dur * 1e6, 3)
            if args:
                rec["args"] = args
            body.append(rec)
        if not metas:
            # The validator requires named lanes; a sample-only dump
            # (metrics without tracing) still declares its one lane.
            metas.append({"ph": "M", "pid": pid, "tid": 0,
                          "name": "thread_name", "args": {"name": "main"}})
        return out + metas + body

    def flush(self, reason, exc=None):
        """Write the ring as ``crashdump.json`` under the run's trace
        directory; returns the path (None on failure — flushing happens
        on paths that are already dying and must not mask the original
        error)."""
        from . import export as _export

        try:
            snapshot = list(self._ring)
            proc = _export.process_section()
            crash = {
                "reason": reason,
                "events": len(snapshot),
                "ring_capacity": self.capacity,
                "ring_drops": self.drops,
                "flushed_at": round(time.time(), 3),
            }
            if exc is not None:
                crash["exception"] = type(exc).__name__
                crash["message"] = str(exc)[:2000]
            doc = {
                "traceEvents": self._events(snapshot),
                "displayTimeUnit": "ms",
                "otherData": {
                    "run": self.run,
                    "wall_start": self.wall_start,
                    "producer": "dampr_tpu_torch.obs.flightrec",
                    "process": proc,
                    "crash": crash,
                },
            }
            log_tail = list(self._log)
            if log_tail:
                doc["otherData"]["log"] = log_tail
            tdir = _export.run_trace_dir(self.run)
            os.makedirs(tdir, exist_ok=True)
            path = os.path.join(tdir, CRASHDUMP_FILE)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
            self.path = path
            self.flush_count += 1
            log.warning("flight recorder: crash dump written to %s (%s)",
                        path, reason)
            return path
        except Exception:
            log.warning("flight recorder flush failed", exc_info=True)
            return None


# -- module-level lifecycle (mirrors trace/metrics) --------------------------

def start(recorder):
    global _active
    with _lock:
        _active = recorder


def stop(recorder):
    global _active
    with _lock:
        if _active is recorder:
            _active = None


def active():
    return _active


def flush_active(reason, exc=None):
    """Flush the live recorder, if any (the ``abort_writes`` hook: the
    kill path may reach the store before the runner's own handler)."""
    rec = _active
    if rec is not None:
        return rec.flush(reason, exc)
    return None


def clear_stale(run_name):
    """Remove a PREVIOUS run's crashdump for this run name (called at
    run start): the dump must describe the latest run, not a long-fixed
    failure."""
    from . import export as _export

    try:
        os.unlink(os.path.join(_export.run_trace_dir(run_name),
                               CRASHDUMP_FILE))
    except OSError:
        pass


def locate_crashdump(run_or_dir):
    """Resolve a run name / run directory / file path to an existing
    crashdump, or None."""
    from . import export as _export

    cands = []
    if os.path.isfile(run_or_dir):
        cands.append(run_or_dir)
    if os.path.isdir(run_or_dir):
        cands.append(os.path.join(run_or_dir, CRASHDUMP_FILE))
        cands.append(os.path.join(run_or_dir, "trace", CRASHDUMP_FILE))
    cands.append(os.path.join(_export.run_trace_dir(run_or_dir),
                              CRASHDUMP_FILE))
    for c in cands:
        if os.path.isfile(c):
            return c
    return None
