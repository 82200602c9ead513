"""Background gauge sampler: the metrics plane's clock.

One daemon thread per metered run snapshots every gauge (pull callbacks
+ pushed values + counters) on the ``settings.metrics_interval_ms``
cadence and appends the result to the registry's in-memory time series
(:meth:`~.metrics.Metrics.record_sample`).  Each sample also lands in
the flight recorder ring (when one is attached), so a crash dump's tail
always carries the most recent gauge state — e.g. the writer-pool queue
depth at the moment of death.

The sampler measures its own cost: each pass's wall time accrues into
the registry's ``sample_seconds``, surfaced as the ``overhead``
self-metric (sampler wall / run wall) in ``stats()``.

Timestamps are ``perf_counter`` seconds relative to the registry epoch —
monotonic non-decreasing by construction, which the export relies on
(Chrome counter events must not go backwards) and tests pin.
"""

import threading
import time

import logging

log = logging.getLogger("dampr_tpu_torch.obs.sampler")


class Sampler(object):
    """Snapshot thread for one :class:`~.metrics.Metrics` registry.

    ``recorder`` (optional) is a :class:`~.flightrec.FlightRecorder`;
    every sample is pushed into its ring alongside recent spans.
    """

    def __init__(self, metrics, interval_ms, recorder=None):
        self.metrics = metrics
        self.interval = max(1, int(interval_ms)) / 1000.0
        self.recorder = recorder
        self._stop = threading.Event()
        self._thread = None

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="dampr-tpu-sampler")
        self._thread.start()

    def stop(self, final_sample=True):
        """Stop the thread (joined briefly — it is a daemon, a wedged
        gauge callback cannot hang run teardown) and take one last
        snapshot so the series always reflects end-of-run state."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
            if t.is_alive():
                log.warning(
                    "metrics sampler thread %s did not stop within "
                    "2.0s at shutdown; abandoning it (daemon) — a "
                    "wedged gauge callback is still sampling", t.name)
        if final_sample:
            try:
                self._sample_once()
            except Exception:
                log.debug("final metrics sample failed", exc_info=True)

    @property
    def alive(self):
        t = self._thread
        return t is not None and t.is_alive()

    # -- sampling -----------------------------------------------------------
    def _sample_once(self):
        m = self.metrics
        t0 = time.perf_counter()
        vals = m.snapshot()
        cost = time.perf_counter() - t0
        # The registry's series store epoch-RELATIVE timestamps (what the
        # trace export emits); the flight recorder stores ABSOLUTE
        # perf_counter values and converts against its own epoch at flush
        # so span and sample clocks agree in the dump.
        m.record_sample(t0 - m.epoch, vals, cost)
        rec = self.recorder
        if rec is not None:
            rec.record_sample(t0, vals)

    def _loop(self):
        # Fixed-cadence loop: sleep to the next multiple of the interval
        # rather than interval-after-work, so a slow gauge pass doesn't
        # silently stretch the cadence (it shows up in ``overhead``
        # instead).
        next_at = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._sample_once()
            except Exception:
                # A broken gauge must degrade observability, not the run.
                log.warning("metrics sample failed", exc_info=True)
            next_at += self.interval
            delay = next_at - time.perf_counter()
            if delay <= 0:
                # Fell behind (pass cost > interval): resync instead of
                # spinning to catch up.
                next_at = time.perf_counter()
                continue
            self._stop.wait(delay)
