"""Live in-run progress reporter: one updating console line per stage.

``settings.progress`` (env ``DAMPR_TPU_TORCH_PROGRESS=1``) makes every
run print a single stderr status line every :data:`INTERVAL_MS`::

    [stage 2/5 map] jobs 12/64 · 1.2M rec/s · 85.3 MB/s · backlog 3q/48MB · eta 0:42

- throughput (records/s, MB/s) is differenced from the metrics plane's
  ``store.records`` / ``store.bytes`` counters between ticks;
- spill backlog is the writer pool's live queue depth and in-flight
  bytes (the gauges the sampler also snapshots);
- ETA extrapolates the current stage's per-job rate over its remaining
  jobs — best effort, ``--:--`` until at least one job lands.

On a TTY the line redraws in place (``\\r``); non-interactive streams
(CI logs, piped benches) get one full line per tick so the history
reads as a coarse timeline.  The reporter is read-only: it consumes the
registry and a runner-maintained status dict, never touching engine
state, and its thread is a daemon — a wedged write can't hold a run's
teardown hostage.
"""

import logging
import sys
import threading
import time

log = logging.getLogger("dampr_tpu_torch.obs.progress")

#: Refresh cadence of the progress line (ms).
INTERVAL_MS = 500


def _fmt_count(n):
    if n >= 1e9:
        return "{:.2f}G".format(n / 1e9)
    if n >= 1e6:
        return "{:.2f}M".format(n / 1e6)
    if n >= 1e3:
        return "{:.1f}k".format(n / 1e3)
    return "{:.0f}".format(n)


def _fmt_eta(secs):
    if secs is None or secs != secs or secs < 0 or secs > 99 * 3600:
        return "--:--"
    secs = int(secs)
    if secs >= 3600:
        return "{}:{:02d}:{:02d}".format(secs // 3600, (secs % 3600) // 60,
                                         secs % 60)
    return "{}:{:02d}".format(secs // 60, secs % 60)


class ProgressReporter(object):
    """Periodic status-line renderer for one run.

    ``status_fn`` returns the runner's live stage dict (stage id/kind,
    jobs done/total, stage start time); ``metrics`` supplies counters
    and pull gauges.  ``stream`` defaults to stderr.
    """

    def __init__(self, metrics, status_fn, interval_ms=500, stream=None):
        self.metrics = metrics
        self.status_fn = status_fn
        self.interval = max(50, int(interval_ms)) / 1000.0
        self.stream = stream if stream is not None else sys.stderr
        self._stop = threading.Event()
        self._thread = None
        self._last = None  # (t, records, bytes) for rate differencing
        self._wrote_inline = False
        self.lines = 0  # ticks rendered (tests observe this)

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dampr-tpu-progress")
        self._thread.start()

    def stop(self):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
            if t.is_alive():
                log.warning(
                    "progress reporter thread %s did not stop within "
                    "2.0s at shutdown; abandoning it (daemon) — a "
                    "wedged stream write is still in flight", t.name)
        if self._wrote_inline:
            try:
                self.stream.write("\n")
                self.stream.flush()
            except Exception:
                pass

    # -- rendering ----------------------------------------------------------
    def _rates(self):
        m = self.metrics
        with m._mu:
            recs = m.counters.get("store.records", 0)
            nbytes = m.counters.get("store.bytes", 0)
        now = time.perf_counter()
        if self._last is None:
            self._last = (now, recs, nbytes)
            return 0.0, 0.0
        t0, r0, b0 = self._last
        dt = max(1e-6, now - t0)
        self._last = (now, recs, nbytes)
        return (recs - r0) / dt, (nbytes - b0) / dt

    def render_line(self):
        st = self.status_fn() or {}
        rec_s, bytes_s = self._rates()
        parts = ["[stage {}/{} {}]".format(
            st.get("sid", "?"), st.get("n_stages", "?"),
            st.get("kind", "?"))]
        total = st.get("jobs_total") or 0
        done = st.get("jobs_done") or 0
        if total:
            parts.append("jobs {}/{}".format(done, total))
        parts.append("{} rec/s".format(_fmt_count(rec_s)))
        parts.append("{:.1f} MB/s".format(bytes_s / 1e6))
        # Spill backlog: live pull of the writer-pool gauges (cheap; the
        # same callbacks the sampler evaluates).
        snap = self.metrics.snapshot()
        q = snap.get("writer.queue_depth", 0)
        inflight = snap.get("writer.inflight_bytes", 0)
        if q or inflight:
            parts.append("backlog {}q/{:.0f}MB".format(
                int(q), inflight / 1e6))
        eta = None
        t0 = st.get("stage_t0")
        if total and done and t0:
            elapsed = time.time() - t0
            eta = elapsed / done * (total - done)
        parts.append("eta {}".format(_fmt_eta(eta)))
        return " · ".join(parts)

    def _tick(self):
        line = self.render_line()
        self.lines += 1
        try:
            if self.stream.isatty():
                self.stream.write("\r\x1b[2K" + line)
                self._wrote_inline = True
            else:
                self.stream.write(line + "\n")
            self.stream.flush()
        except Exception:
            pass  # a closed/odd stream must never fail the run

    def _loop(self):
        while not self._stop.wait(self.interval):
            try:
                self._tick()
            except Exception:
                pass
