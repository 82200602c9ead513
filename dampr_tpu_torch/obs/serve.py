"""Live metrics endpoint: one stdlib HTTP thread per run.

Port of ``dampr_tpu/obs/serve.py``, whole, exposing the live metrics
registry while a run is in flight:

- ``GET /metrics``: Prometheus text (version 0.0.4) of the active
  registry (:func:`.promtext.render`), every sample rank-labelled.  A
  process with no metered run in flight serves the empty exposition
  (zero samples, valid), never an error.
- ``GET /healthz``: JSON liveness: run name, rank, whether a registry is
  live.

Enabled by ``settings.metrics_port`` (0 = off): the runner starts one
server per run on ``metrics_port + rank``, and the port implies the
100 ms sampler so the gauges move; the rank is the process group's
(:func:`rank_info`).  Request handling never touches the run's hot path:
a scrape costs one registry snapshot.
"""

import json
import logging
import threading

log = logging.getLogger("dampr_tpu_torch.obs.serve")

#: The exposition content type Prometheus scrapers negotiate.
METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def rank_info():
    """``(process_id, num_processes)`` (:func:`..parallel.mesh.rank_info`:
    the process group's, else the launcher environment's; touches no
    device)."""
    from ..parallel.mesh import rank_info as _rank_info

    return _rank_info()


class MetricsServer(object):
    """One rank's live observability endpoint.

    Serves whatever registry is ACTIVE at request time
    (:func:`.metrics.active`) rather than binding one
    registry at construction — the server outlives nothing (the runner
    stops it at run teardown), but within a run this also makes it
    correct for nested runs (innermost registry wins, same contract as
    the tracer)."""

    def __init__(self, port, run_name=None, rank=None, num_processes=None):
        pid, num = rank_info()
        self.rank = pid if rank is None else rank
        self.num_processes = num if num_processes is None else num_processes
        self.run_name = run_name
        #: Requested port BEFORE the per-rank offset; 0 = OS-assigned
        #: (tests).  ``self.port`` is the live bound port after start().
        self.base_port = int(port)
        self.port = None
        #: True when the per-rank port was taken and the endpoint bound
        #: a fallback port instead (concurrent runs on one box); the
        #: runner records the live port in ``stats()["endpoint"]`` so
        #: scrapers can still find the rank.
        self.fallback = False
        self._httpd = None
        self._thread = None

    # -- request handling ---------------------------------------------------
    def _metrics_text(self):
        from . import metrics as _metrics, promtext

        reg = _metrics.active()
        if reg is None:
            return ""
        return promtext.render(reg, rank=self.rank)

    def _health(self):
        from . import metrics as _metrics

        reg = _metrics.active()
        return {
            "status": "ok",
            "run": (reg.run if reg is not None else self.run_name),
            "process_id": self.rank,
            "num_processes": self.num_processes,
            "metrics_live": reg is not None,
        }

    # -- lifecycle ----------------------------------------------------------
    def start(self):
        """Bind and serve on a daemon thread.  Returns self, or None
        when the bind fails (port taken): a busy port degrades the
        endpoint, never the run."""
        import http.server

        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                try:
                    if self.path.split("?")[0] == "/metrics":
                        body = server._metrics_text().encode("utf-8")
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         METRICS_CONTENT_TYPE)
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    elif self.path.split("?")[0] == "/healthz":
                        body = json.dumps(server._health()).encode("utf-8")
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/json")
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    else:
                        self.send_error(404)
                except (BrokenPipeError, ConnectionResetError):
                    pass  # scraper went away mid-response

            def log_message(self, fmt, *args):
                log.debug("metrics endpoint: " + fmt, *args)

        from . import log as _obslog

        requested = self.base_port
        if requested > 0:
            # Per-rank offset: co-located ranks each get their own port
            # (rank 0 = the configured port, rank k = port + k).
            requested += self.rank
        # Port-collision fallback: when the per-rank port is taken
        # (back-to-back runs racing teardown, or two fleets sharing one
        # box and one base port), probe the next free ports ABOVE the
        # fleet's block (base + num_processes..) instead of giving up —
        # a second run's endpoint must not silently vanish, and it must
        # not steal a sibling rank's expected port either.
        candidates = [requested]
        if requested > 0:
            probe_base = self.base_port + max(1, int(self.num_processes
                                                     or 1))
            candidates += [p for p in range(probe_base, probe_base + 32)
                           if p != requested]
        err = None
        for port in candidates:
            try:
                self._httpd = http.server.ThreadingHTTPServer(
                    ("", port), Handler)
                break
            except OSError as e:
                err = e
        if self._httpd is None:
            _obslog.warn(
                "metrics-bind-failed",
                "metrics endpoint bind failed on port %d (and %d fallback "
                "probes): %s (endpoint disabled for this run)", requested,
                len(candidates) - 1, err, logger=log, rank=self.rank)
            return None
        self.port = self._httpd.server_address[1]
        self.fallback = requested > 0 and self.port != requested
        if self.fallback:
            _obslog.warn(
                "metrics-port-fallback",
                "metrics endpoint port %d was taken; rank %d bound the "
                "next free port %d instead (recorded in stats)",
                requested, self.rank, self.port, logger=log,
                requested=requested, bound=self.port)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dampr-tpu-torch-metrics-http")
        self._thread.start()
        log.info("metrics endpoint: rank %d serving /metrics + /healthz "
                 "on port %d", self.rank, self.port)
        return self

    def stop(self):
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:
                log.debug("metrics endpoint shutdown failed",
                          exc_info=True)
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)
            if t.is_alive():
                log.warning(
                    "metrics endpoint thread %s did not stop within "
                    "2.0s at shutdown; abandoning it (daemon) — a "
                    "wedged in-flight request is still being served",
                    t.name)


def start_server(port, run_name=None):
    """Convenience for the runner: build + start, returning the live
    server or None (bind failure / port <= 0 with no override)."""
    if port is None:
        return None
    srv = MetricsServer(port, run_name=run_name)
    return srv.start()
