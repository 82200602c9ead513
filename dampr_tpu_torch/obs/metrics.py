"""Run-scoped live metrics registry: counters, gauges, histograms.

The continuous-signal counterpart of :mod:`.trace`'s span timeline.
Spans answer "what happened, when"; the metrics plane answers "what is
the system doing RIGHT NOW" — budget occupancy, writer-pool backlog,
overlap-window depth, records/s — the signals an operator (or an
autoscaler, per the tf.data-service disaggregation argument) needs while
a run is still in flight, not after ``_finalize_obs`` writes the trace.

Design contract, identical to :mod:`.trace`:

1. **Near-zero cost off.**  With no active registry, every module-level
   instrumentation call (``counter_add`` / ``gauge_set`` / ``observe``)
   is one module-global load + ``None`` check and returns.  The engine
   instruments its hot boundaries unconditionally and relies on this;
   ``settings.metrics_interval_ms = 0`` (the default) never starts a
   registry.
2. **Pull-first gauges.**  Load-bearing occupancy gauges (resident
   bytes, queue depth, HBM residency) register a *callback* once at run
   start (:meth:`Metrics.register_gauge`); the hot paths that mutate the
   underlying counters pay nothing extra — the background sampler
   (:mod:`.sampler`) evaluates the callbacks on its cadence.  Pushed
   gauges (``gauge_set``) exist for values with no stable home to poll.
3. **Lock-light.**  Counter/histogram updates take one small lock (they
   are per-block, never per-record); the sampler snapshots under the
   same lock so a snapshot is internally consistent.

The sampler owns the time series (``Metrics.series``): per-series sample
lists bounded at :data:`SERIES_CAP` with an explicit drop count, timestamps in perf_counter
seconds relative to the registry epoch (monotonic by construction).  The
series feed three consumers: Chrome-trace counter tracks (``"ph":"C"``
events, :mod:`.export`), the live progress line (:mod:`.progress`), and
the flight recorder's crash timeline (:mod:`.flightrec`).

Scope mirrors the tracer: the active registry is process-global, owned
run-scoped via ``start``/``stop``.  Two concurrent metered runs in one
process would interleave into the innermost registry; run-level summary
numbers stay exact regardless (they come from the runner's own
counters).
"""

import threading
import time

from .. import settings

#: The active registry or None.  Read unlocked on the hot path;
#: start/stop mutate under _lock.
#: Samples kept per series; past it the oldest drop and are counted.
SERIES_CAP = 4096

_active = None
_stack = []
_lock = threading.Lock()


class Metrics(object):
    """One run's metric collection.

    - ``counters``: name -> monotonically increasing float (records,
      bytes, stall events).
    - ``gauges``: name -> last pushed value (``gauge_set``).
    - ``gauge_fns``: name -> zero-arg callable returning the live value;
      evaluated by the sampler (and by :meth:`snapshot`).
    - ``hists``: name -> {count, sum, min, max} summary (merge fan-in,
      sample durations) — dependency-free, no bucket math.
    - ``series``: name -> list of ``(t, value)`` samples appended by the
      sampler, each capped at :data:`SERIES_CAP` with
      ``series_drops`` counting evictions.
    """

    def __init__(self, run_name):
        self.run = run_name
        self.epoch = time.perf_counter()
        self.wall_start = time.time()
        self._mu = threading.Lock()
        self.counters = {}
        self.gauges = {}
        self.gauge_fns = {}
        self.hists = {}
        self.series = {}
        self.series_drops = 0
        # Sampler self-accounting (the plane measures its own cost):
        # cumulative wall seconds spent inside snapshot passes, and the
        # sample count — overhead() divides by elapsed run time.
        self.sample_count = 0
        self.sample_seconds = 0.0

    # -- recording ----------------------------------------------------------
    def counter_add(self, name, n=1):
        with self._mu:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge_set(self, name, value):
        with self._mu:
            self.gauges[name] = value

    def observe(self, name, value):
        with self._mu:
            h = self.hists.get(name)
            if h is None:
                h = self.hists[name] = {"count": 0, "sum": 0.0,
                                        "min": value, "max": value}
            h["count"] += 1
            h["sum"] += value
            if value < h["min"]:
                h["min"] = value
            if value > h["max"]:
                h["max"] = value

    def register_gauge(self, name, fn):
        """Install a pull gauge: ``fn()`` is evaluated at sample time.
        Registration happens once per run (runner setup), so the sites
        whose state it reads pay nothing on their hot paths."""
        with self._mu:
            self.gauge_fns[name] = fn

    # -- sampling -----------------------------------------------------------
    def snapshot(self):
        """One consistent gauge read: pull gauges evaluated, pushed
        gauges and counters included (counters ARE the throughput
        series — the consumer differences them).  Broken callbacks are
        dropped for the rest of the run rather than killing the
        sampler."""
        vals = {}
        dead = []
        with self._mu:
            fns = list(self.gauge_fns.items())
            vals.update(self.gauges)
            vals.update(self.counters)
        for name, fn in fns:
            try:
                v = fn()
            except Exception:
                dead.append(name)
                continue
            if v is not None:
                vals[name] = v
        if dead:
            with self._mu:
                for name in dead:
                    self.gauge_fns.pop(name, None)
        return vals

    def record_sample(self, t, vals, cost_seconds):
        """Append one sampler pass to the time series (called by the
        sampler thread only).  ``t`` is perf_counter seconds relative to
        ``epoch``; per-series caps evict the oldest sample and count the
        drop."""
        cap = max(2, SERIES_CAP)
        with self._mu:
            self.sample_count += 1
            self.sample_seconds += cost_seconds
            for name, v in vals.items():
                s = self.series.get(name)
                if s is None:
                    s = self.series[name] = []
                if len(s) >= cap:
                    del s[0]
                    self.series_drops += 1
                s.append((t, v))

    def overhead(self):
        """Sampler wall seconds / run wall seconds so far — the metrics
        plane's self-metric."""
        elapsed = time.perf_counter() - self.epoch
        if elapsed <= 0:
            return 0.0
        return self.sample_seconds / elapsed

    # -- summary ------------------------------------------------------------
    def summary(self):
        """The ``metrics`` section of stats.json: final counters, last/
        peak gauge values per series, histogram summaries, and the
        sampler's self-accounting."""
        with self._mu:
            counters = dict(self.counters)
            hists = {k: dict(v) for k, v in self.hists.items()}
            series_meta = {}
            for name, s in self.series.items():
                if not s:
                    continue
                vals = [v for _t, v in s]
                series_meta[name] = {
                    "samples": len(s),
                    "last": vals[-1],
                    "peak": max(vals),
                }
            n_samples = self.sample_count
            drops = self.series_drops
            sample_secs = self.sample_seconds
        return {
            "counters": counters,
            "histograms": hists,
            "series": series_meta,
            "sampler": {
                "interval_ms": settings.effective_metrics_interval_ms(),
                "samples": n_samples,
                "series_drops": drops,
                "sample_seconds": round(sample_secs, 6),
                "overhead": round(self.overhead(), 6),
            },
        }


# -- module-level API (the instrumentation surface) -------------------------

def start(metrics):
    """Make ``metrics`` the active registry (run-scoped: pair with
    stop)."""
    global _active
    with _lock:
        _stack.append(metrics)
        _active = metrics


def stop(metrics):
    global _active
    with _lock:
        if metrics in _stack:
            _stack.remove(metrics)
        _active = _stack[-1] if _stack else None


def active():
    return _active


def enabled():
    return _active is not None


def counter_add(name, n=1):
    m = _active
    if m is not None:
        m.counter_add(name, n)


def gauge_set(name, value):
    m = _active
    if m is not None:
        m.gauge_set(name, value)


def observe(name, value):
    m = _active
    if m is not None:
        m.observe(name, value)


def register_gauge(name, fn):
    m = _active
    if m is not None:
        m.register_gauge(name, fn)
