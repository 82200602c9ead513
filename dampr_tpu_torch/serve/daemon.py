"""The pipeline service daemon: HTTP plane, scheduler and job lifecycle.

Port of ``dampr_tpu/serve/daemon.py``; run it as
``python -m dampr_tpu_torch.serve.daemon``.  One :class:`ServeDaemon`
owns:

- the **HTTP endpoints** (stdlib ``ThreadingHTTPServer``): ``POST
  /submit`` (wire envelope in, job id out), ``GET /jobs[/<id>]``, ``GET
  /result/<id>`` (the worker's result bytes, verbatim), ``POST
  /cancel/<id>``, ``POST /drain``, and ``GET /metrics`` (Prometheus text,
  per-tenant labels) and ``GET /healthz``;
- the **admission gate**: decode (a :class:`~.wire.WireError` is a coded
  reject), the ``analyze.validate`` pre-flight with multi-process
  promotion (an unpicklable capture is a ``DTA401`` error: it is about
  to cross a process boundary), the fingerprint, the in-flight
  coalesce, and the scheduler's budget and queue-depth charge.  The gate
  never runs a device program (the traceability probe is off), so the
  daemon never creates a CUDA context: only its workers touch the card;
- the **dispatch loop**: worker slots drained deficit-round-robin into
  per-job subprocesses (:mod:`.worker`), each watched by a waiter thread
  that enforces the per-job timeout (SIGTERM first, the child's
  crashdump path, then SIGKILL);
- the **drain protocol**: :meth:`ServeDaemon.drain` (SIGTERM in
  :func:`main`) stops admitting, finishes what was admitted, and
  terminates stragglers at the deadline.

Every lifecycle transition emits a coded event (``serve-*``, registered
in ``obs.log.EVENT_CODES``) into the daemon's own ``events.jsonl``, and
each finished job appends a per-tenant telemetry point (run
``serve-<tenant>``, :mod:`..obs.timeseries`).

A worker inherits the daemon's environment and, where a test or script
sets them at run time, its *live* scratch root and device, and the
shared cache directory, so every worker of one daemon shares one cache
and runs where the daemon was told to.
"""

import base64
import collections
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time

from .. import settings
from ..obs import log as _obslog
from ..obs import timeseries as _timeseries
from ..obs.serve import METRICS_CONTENT_TYPE
from . import scheduler as _scheduler
from . import wire as _wire

log = logging.getLogger("dampr_tpu_torch.serve")


def _state_dir():
    return settings.serve_dir or os.path.join(settings.scratch_root, "serve")


class ServeDaemon(object):
    def __init__(self, port=None, host=None, workers=None,
                 tenant_budget=None, quantum=None, queue_depth=None,
                 state_dir=None, name="serve"):
        self.name = name
        self.host = settings.serve_host if host is None else host
        self.base_port = settings.serve_port if port is None else int(port)
        self.port = None
        self.workers = max(1, settings.serve_workers if workers is None
                           else int(workers))
        self.state_dir = state_dir or _state_dir()
        self.sched = _scheduler.Scheduler(
            settings.serve_tenant_budget if tenant_budget is None
            else tenant_budget,
            settings.serve_quantum if quantum is None else quantum,
            settings.serve_queue_depth if queue_depth is None
            else queue_depth)
        self.jobs = collections.OrderedDict()
        self.draining = False
        self.started_at = time.time()
        self.counters = collections.Counter()
        self._seq = 0
        self._running = {}      # job id -> subprocess.Popen
        self._lock = threading.RLock()
        self._wake = threading.Condition(self._lock)
        self._stopped = False
        self._httpd = None
        self._http_thread = None
        self._dispatcher = None
        self._waiters = []
        os.makedirs(os.path.join(self.state_dir, "jobs"), exist_ok=True)
        # The daemon's own structured event stream (NOT the run-scoped
        # module-global one: served runs start/stop their own streams in
        # worker processes, and tests host several daemons in-process).
        self._stream = _obslog.LogStream(
            "serve", level="info",
            path=os.path.join(self.state_dir, "events.jsonl"))

    # -- coded events --------------------------------------------------------
    def emit(self, level, code, msg, **data):
        self.counters[code] += 1
        try:
            self._stream.emit(level, code, msg, data=data or None)
        except Exception:
            pass
        (log.warning if level in ("warn", "error") else log.info)(
            "%s: %s", code, msg)

    # -- submission ----------------------------------------------------------
    def submit(self, request):
        """One submission request (the parsed /submit JSON body) ->
        ``(http_status, response_dict)``."""
        tenant = str(request.get("tenant") or "default")
        self.emit("info", "serve-submit",
                    "submission from tenant {!r}".format(tenant),
                    tenant=tenant)
        try:
            payload = base64.b64decode(request["plan"])
        except Exception:
            return self._reject(tenant, "wire", 400,
                                "submission carries no decodable plan")
        try:
            graph, source = _wire.decode(payload)
        except _wire.WireError as e:
            return self._reject(tenant, "wire", 400, str(e))

        # Pre-flight admission gate: the submission is about to cross a
        # process boundary, so unpicklable captures are errors (DTA401),
        # exactly as validate's num_processes>1 promotion defines.  The
        # traceability probe is advisory and runs a device program: off
        # here, so the daemon never holds a CUDA context.
        from ..analyze import validate as _validate

        try:
            diags = _validate.validate_graph(
                graph, num_processes=2, probe_traceable=False,
                probe_assoc=True, probe_pickle=True)
        except Exception as e:
            return self._reject(tenant, "invalid", 422,
                                "pre-flight validation crashed: {}".format(e))
        errors = [d for d in diags if d.severity == "error"]
        if errors:
            return self._reject(
                tenant, "invalid", 422,
                "; ".join("{}: {}".format(d.code, d.message)
                          for d in errors),
                diagnostics=[d.to_dict() for d in errors])

        fingerprint = _wire.plan_fingerprint(graph, source)
        volatile = _wire.is_volatile(fingerprint)
        cost = _wire.estimate_input_bytes(graph)
        options = {
            "reuse": str(request.get("reuse") or "auto"),
            "timeout_s": request.get("timeout_s"),
            "label": request.get("label"),
        }
        with self._wake:
            if self.draining or self._stopped:
                return self._reject(tenant, "draining", 503,
                                    "daemon is draining; not accepting "
                                    "new submissions")
            self._seq += 1
            job = _scheduler.Job("j%04d" % self._seq, tenant, fingerprint,
                                 cost, payload=payload, options=options)
            job.diagnostics = [d.to_dict() for d in diags]
            primary = None
            if not volatile and options["reuse"] != "off":
                primary = self.sched.coalesce_target(fingerprint)
            if primary is not None:
                self.sched.attach_follower(primary, job)
                self.jobs[job.id] = job
                self.emit(
                    "info", "serve-coalesce",
                    "job {} (tenant {!r}) coalesced onto in-flight {} — "
                    "identical fingerprint {}".format(
                        job.id, tenant, primary.id, fingerprint[:16]),
                    job=job.id, tenant=tenant, primary=primary.id,
                    fingerprint=fingerprint[:16])
                return 200, {"job": job.id, "state": job.state,
                             "primary": primary.id,
                             "fingerprint": fingerprint}
            try:
                self.sched.admit(job)
            except _scheduler.AdmissionError as e:
                return self._reject(tenant, e.reason, 429, str(e))
            self.jobs[job.id] = job
            self.emit(
                "info", "serve-admit",
                "job {} admitted for tenant {!r}: {} byte(s) reserved, "
                "fingerprint {}".format(job.id, tenant, cost,
                                        fingerprint[:16]),
                job=job.id, tenant=tenant, cost_bytes=cost,
                fingerprint=fingerprint[:16])
            self._wake.notify_all()
        return 200, {"job": job.id, "state": job.state, "primary": None,
                     "fingerprint": fingerprint}

    def _reject(self, tenant, reason, status, message, diagnostics=None):
        self.sched.tenant(tenant).counts["rejected"] += 1
        self.emit("warn", "serve-reject",
                    "submission from tenant {!r} rejected ({}): {}".format(
                        tenant, reason, message),
                    tenant=tenant, reason=reason)
        doc = {"error": message, "reason": reason}
        if diagnostics:
            doc["diagnostics"] = diagnostics
        return status, doc

    # -- cancellation --------------------------------------------------------
    def cancel(self, job_id):
        with self._wake:
            job = self.jobs.get(job_id)
            if job is None:
                return 404, {"error": "no such job", "reason": "unknown"}
            if job.state in _scheduler.TERMINAL:
                return 200, {"job": job.id, "state": job.state}
            job.cancel_requested = True
            if job.state == "queued" and self.sched.remove_queued(job):
                job.state = "cancelled"
                job.finished_at = time.time()
                # The whole point of reservation-until-terminal: a
                # cancelled job's bytes return to the tenant NOW.
                self.sched.release(job)
                self._wake.notify_all()
            elif job.state == "running":
                proc = self._running.get(job.id)
                if proc is not None:
                    try:
                        proc.terminate()  # SIGTERM -> child crashdump path
                    except OSError:
                        pass
            elif job.state == "coalesced":
                # The primary keeps running — its other clients still
                # want the result; only this follower is abandoned.
                job.state = "cancelled"
                job.finished_at = time.time()
            return 200, {"job": job.id, "state": job.state}

    # -- dispatch ------------------------------------------------------------
    def _dispatch_loop(self):
        while True:
            with self._wake:
                while not self._stopped:
                    if len(self._running) < self.workers:
                        job = self.sched.next_job()
                        if job is not None:
                            break
                    self._wake.wait(timeout=0.5)
                else:
                    return
                self._spawn(job)

    def _spawn(self, job):
        job_dir = os.path.join(self.state_dir, "jobs", job.id)
        os.makedirs(job_dir, exist_ok=True)
        job.job_dir = job_dir
        job.run_name = "serve-{}-{}".format(job.tenant, job.id)
        with open(os.path.join(job_dir, "payload.bin"), "wb") as f:
            f.write(job.payload)
        job.payload = None  # the file is the source of truth now
        with open(os.path.join(job_dir, "job.json"), "w") as f:
            json.dump({"run_name": job.run_name, "tenant": job.tenant,
                       "resume": "auto", "options": job.options}, f)

        env = dict(os.environ)
        # The worker inherits the daemon's *live* settings, not just its
        # env: tests repoint scratch_root and the device at runtime, and
        # a worker must run where the daemon was told to (a CPU test
        # daemon's worker must not ask for a card).
        env["DAMPR_TPU_TORCH_SERVE_ACTIVE"] = "1"  # reuse "auto" -> ON
        env["DAMPR_TPU_TORCH_SCRATCH"] = settings.scratch_root
        env["DAMPR_TPU_TORCH_DEVICE"] = str(settings.device)
        env["DAMPR_TPU_TORCH_TRACE"] = "1" if settings.serve_trace else "0"
        env["DAMPR_TPU_TORCH_TRACE_DIR"] = os.path.join(job_dir, "trace")
        if settings.reuse_dir:
            env["DAMPR_TPU_TORCH_REUSE_DIR"] = settings.reuse_dir
        if job.options.get("reuse") == "off":
            env["DAMPR_TPU_TORCH_REUSE"] = "0"
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")

        child_log = open(os.path.join(job_dir, "child.log"), "wb")
        try:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dampr_tpu_torch.serve.worker", job_dir],
                env=env, stdout=child_log, stderr=subprocess.STDOUT)
        except OSError as e:
            child_log.close()
            job.state = "failed"
            job.error = "worker spawn failed: {}".format(e)
            job.finished_at = time.time()
            self._finish(job)
            return
        child_log.close()
        job.state = "running"
        job.started_at = time.time()
        self._running[job.id] = proc
        waiter = threading.Thread(
            target=self._wait_for, args=(job, proc),
            name="dampr-tpu-torch-serve-wait-{}".format(job.id),
            daemon=True)
        self._waiters.append(waiter)
        waiter.start()

    def _wait_for(self, job, proc):
        timeout = job.options.get("timeout_s")
        if not timeout:
            ms = settings.serve_job_timeout_ms
            timeout = (ms / 1000.0) if ms > 0 else None
        timed_out = False
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            timed_out = True
            try:
                proc.terminate()  # SIGTERM: schema-valid crashdump, 143
                proc.wait(timeout=20)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self._reap(job, proc, timed_out)

    def _reap(self, job, proc, timed_out):
        meta, error = {}, None
        try:
            with open(os.path.join(job.job_dir, "result.json")) as f:
                meta = json.load(f)
        except (OSError, ValueError):
            pass
        try:
            with open(os.path.join(job.job_dir, "error.json")) as f:
                error = json.load(f)
        except (OSError, ValueError):
            pass
        dump = os.path.join(job.job_dir, "trace", job.run_name, "trace",
                            "crashdump.json")
        with self._wake:
            self._running.pop(job.id, None)
            job.exit_code = proc.returncode
            job.finished_at = time.time()
            job.result_meta = meta
            if os.path.isfile(dump):
                job.crashdump = dump
            result_ok = (proc.returncode == 0 and os.path.isfile(
                os.path.join(job.job_dir, "result.pkl")))
            if job.cancel_requested and not result_ok:
                job.state = "cancelled"
                job.error = "cancelled by client"
            elif timed_out:
                job.state = "failed"
                job.error = "killed: exceeded job timeout"
            elif result_ok:
                job.state = "done"
            else:
                job.state = "failed"
                job.error = ((error or {}).get("message")
                             or "worker exited {}".format(proc.returncode))
            self._finish(job)
            self._wake.notify_all()

    def _finish(self, job):
        """Terminal bookkeeping (lock held): release the reservation,
        resolve followers, emit telemetry, prune old records."""
        self.sched.release(job)
        for fid in job.followers:
            follower = self.jobs.get(fid)
            if follower is not None and follower.state == "coalesced":
                follower.state = job.state
                follower.finished_at = job.finished_at
                follower.error = job.error
                follower.result_meta = job.result_meta
        # Per-tenant telemetry point: served tenants trend like any run
        # series (run name serve-<tenant>, keyed by plan fingerprint).
        wall = (job.result_meta or {}).get("wall_seconds")
        if job.state == "done" and isinstance(wall, (int, float)):
            point = {"schema": _timeseries.SCHEMA,
                     "run": "serve-" + job.tenant, "ts": time.time(),
                     "fingerprint": (job.fingerprint or "")[:32],
                     "wall_seconds": round(float(wall), 6)}
            hits = ((job.result_meta.get("reuse") or {}).get("hits"))
            if isinstance(hits, int):
                point["reuse_hit_rate"] = float(min(1, hits))
            _timeseries.append_point(point)
        self._prune()

    def _prune(self):
        keep = max(1, settings.serve_jobs_keep)
        terminal = [j for j in self.jobs.values()
                    if j.state in _scheduler.TERMINAL]
        excess = len(terminal) - keep
        if excess <= 0:
            return
        evicted = []
        for job in terminal[:excess]:
            del self.jobs[job.id]
            evicted.append(job.id)
            if job.job_dir:
                shutil.rmtree(job.job_dir, ignore_errors=True)
        self.emit(
            "info", "serve-evict",
            "evicted {} retired job record(s) past the retention bound "
            "({} kept): {}".format(len(evicted), keep,
                                   ", ".join(evicted)),
            evicted=len(evicted), keep=keep)

    # -- drain / lifecycle ---------------------------------------------------
    def drain(self, timeout_s=None):
        """Stop admitting, finish everything already admitted, terminate
        stragglers at the deadline.  Returns the number of jobs still
        running when the deadline fired (0 = clean drain)."""
        with self._wake:
            already = self.draining
            self.draining = True
        if not already:
            self.emit(
                "warn", "serve-drain",
                "drain initiated: finishing admitted jobs, rejecting new "
                "submissions", inflight=len(self._running))
        if timeout_s is None:
            timeout_s = settings.serve_drain_ms / 1000.0
        deadline = time.time() + timeout_s
        with self._wake:
            while time.time() < deadline:
                busy = len(self._running) + sum(
                    1 for j in self.jobs.values() if j.state == "queued")
                if not busy:
                    break
                self._wake.wait(timeout=min(0.5, max(
                    0.01, deadline - time.time())))
            stragglers = list(self._running.values())
        for proc in stragglers:
            try:
                proc.terminate()
            except OSError:
                pass
        return len(stragglers)

    def start(self):
        """Bind the HTTP plane and start the dispatcher.  Returns self,
        or None when every bind candidate is taken (mirrors
        ``obs.serve``: a busy port degrades, never crashes)."""
        import http.server

        handler = self._make_handler()
        candidates = [self.base_port]
        if self.base_port > 0:
            candidates += list(range(self.base_port + 1,
                                     self.base_port + 17))
        err = None
        for port in candidates:
            try:
                self._httpd = http.server.ThreadingHTTPServer(
                    (self.host, port), handler)
                break
            except OSError as e:
                err = e
        if self._httpd is None:
            log.error("serve daemon bind failed on port %d (+%d probes): "
                      "%s", self.base_port, len(candidates) - 1, err)
            return None
        self.port = self._httpd.server_address[1]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="dampr-tpu-torch-serve-http")
        self._http_thread.start()
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="dampr-tpu-torch-serve-dispatch")
        self._dispatcher.start()
        log.info("serve daemon up on %s:%d (%d worker slot(s), state %s)",
                 self.host, self.port, self.workers, self.state_dir)
        return self

    def stop(self):
        with self._wake:
            self._stopped = True
            self.draining = True
            self._wake.notify_all()
        for proc in list(self._running.values()):
            try:
                proc.terminate()
            except OSError:
                pass
        for waiter in self._waiters:
            waiter.join(timeout=30)
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5)
        httpd, self._httpd = self._httpd, None
        if httpd is not None:
            try:
                httpd.shutdown()
                httpd.server_close()
            except Exception:
                log.debug("serve daemon shutdown failed", exc_info=True)
        if self._http_thread is not None:
            self._http_thread.join(timeout=2)

    # -- telemetry plane -----------------------------------------------------
    def jobs_doc(self):
        with self._lock:
            rows = [j.to_row() for j in self.jobs.values()]
            tenants = self.sched.stats()
        return {"schema": "dampr-tpu-serve-jobs/1", "daemon": self.name,
                "draining": self.draining,
                "uptime_s": round(time.time() - self.started_at, 3),
                "workers": self.workers, "jobs": rows, "tenants": tenants}

    def health(self):
        with self._lock:
            states = collections.Counter(
                j.state for j in self.jobs.values())
            return {"status": "draining" if self.draining else "ok",
                    "role": "serve", "daemon": self.name,
                    "uptime_s": round(time.time() - self.started_at, 3),
                    "workers": self.workers,
                    "running": len(self._running),
                    "jobs": dict(states)}

    def metrics_text(self):
        from ..obs.promtext import escape_label_value as esc

        lines = ["# Serve daemon exposition (dampr_tpu_torch.serve)"]
        with self._lock:
            states = collections.Counter()
            reuse_hits = collections.Counter()
            for j in self.jobs.values():
                states[(j.tenant, j.state)] += 1
                hits = (j.result_meta or {}).get("reuse") or {}
                if isinstance(hits.get("hits"), int):
                    reuse_hits[j.tenant] += hits["hits"]
            for (tenant, state), n in sorted(states.items()):
                lines.append(
                    'dampr_tpu_serve_jobs{{tenant="{}",state="{}"}} {}'
                    .format(esc(tenant), esc(state), n))
            for tenant, stats in sorted(self.sched.stats().items()):
                t = esc(tenant)
                lines.append(
                    'dampr_tpu_serve_queue_depth{tenant="%s"} %d'
                    % (t, stats["queued"]))
                lines.append(
                    'dampr_tpu_serve_reserved_bytes{tenant="%s"} %d'
                    % (t, stats["reserved_bytes"]))
                lines.append(
                    'dampr_tpu_serve_budget_bytes{tenant="%s"} %d'
                    % (t, stats["budget_bytes"]))
            for tenant, hits in sorted(reuse_hits.items()):
                lines.append(
                    'dampr_tpu_serve_reuse_hits_total{tenant="%s"} %d'
                    % (esc(tenant), hits))
            for code in ("serve-submit", "serve-admit", "serve-reject",
                         "serve-coalesce", "serve-evict", "serve-drain"):
                lines.append(
                    'dampr_tpu_serve_events_total{code="%s"} %d'
                    % (esc(code), self.counters.get(code, 0)))
            lines.append("dampr_tpu_serve_running %d" % len(self._running))
            lines.append("dampr_tpu_serve_draining %d"
                         % (1 if self.draining else 0))
            lines.append("dampr_tpu_serve_uptime_seconds %.3f"
                         % (time.time() - self.started_at))
        return "\n".join(lines) + "\n"

    # -- HTTP ----------------------------------------------------------------
    def _make_handler(self):
        import http.server

        daemon = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, status, body, ctype="application/json"):
                try:
                    self.send_response(status)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _send_json(self, status, doc):
                self._send(status, json.dumps(doc, default=str,
                                              sort_keys=True).encode())

            def do_GET(self):  # noqa: N802 - http.server API
                path = self.path.split("?")[0].rstrip("/") or "/"
                try:
                    if path == "/jobs":
                        self._send_json(200, daemon.jobs_doc())
                    elif path.startswith("/jobs/"):
                        job = daemon.jobs.get(path[len("/jobs/"):])
                        if job is None:
                            self._send_json(404, {"error": "no such job"})
                        else:
                            self._send_json(200, job.to_row())
                    elif path.startswith("/result/"):
                        self._result(path[len("/result/"):])
                    elif path == "/metrics":
                        self._send(200, daemon.metrics_text().encode(),
                                   METRICS_CONTENT_TYPE)
                    elif path == "/healthz":
                        self._send_json(200, daemon.health())
                    else:
                        self.send_error(404)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def _result(self, job_id):
                job = daemon.jobs.get(job_id)
                if job is not None and job.primary:
                    job = daemon.jobs.get(job.primary) or job
                if job is None:
                    self._send_json(404, {"error": "no such job"})
                    return
                if job.state == "done":
                    path = os.path.join(job.job_dir, "result.pkl")
                    try:
                        with open(path, "rb") as f:
                            body = f.read()
                    except OSError:
                        self._send_json(
                            410, {"error": "result evicted",
                                  "reason": "evicted"})
                        return
                    self._send(200, body, "application/octet-stream")
                elif job.state in _scheduler.TERMINAL:
                    self._send_json(410, {
                        "error": job.error or "job did not complete",
                        "state": job.state, "crashdump": job.crashdump})
                else:
                    self._send_json(409, {"error": "not finished",
                                          "state": job.state})

            def do_POST(self):  # noqa: N802 - http.server API
                path = self.path.split("?")[0].rstrip("/")
                try:
                    length = int(self.headers.get("Content-Length") or 0)
                    body = self.rfile.read(length) if length else b""
                    if path == "/submit":
                        try:
                            request = json.loads(body.decode("utf-8"))
                        except (ValueError, UnicodeDecodeError):
                            self._send_json(400, {
                                "error": "submission body is not JSON",
                                "reason": "wire"})
                            return
                        status, doc = daemon.submit(request)
                        self._send_json(status, doc)
                    elif path.startswith("/cancel/"):
                        status, doc = daemon.cancel(path[len("/cancel/"):])
                        self._send_json(status, doc)
                    elif path == "/drain":
                        threading.Thread(target=daemon.drain,
                                         daemon=True).start()
                        self._send_json(200, {"draining": True})
                    else:
                        self.send_error(404)
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def log_message(self, fmt, *args):
                log.debug("serve http: " + fmt, *args)

        return Handler


def main(argv=None):
    """``python -m dampr_tpu_torch.serve.daemon``: run the daemon until
    SIGTERM/SIGINT, then drain gracefully (finish admitted jobs, reject
    new ones) and exit."""
    import argparse
    import signal

    p = argparse.ArgumentParser(
        prog="python -m dampr_tpu_torch.serve.daemon",
        description="multi-tenant pipeline service daemon")
    p.add_argument("--port", type=int, default=None,
                   help="HTTP port (default: settings.serve_port = "
                        "DAMPR_TPU_TORCH_SERVE_PORT; 0 = any free port)")
    p.add_argument("--host", default=None,
                   help="bind address (default: settings.serve_host, "
                        "loopback)")
    p.add_argument("--workers", type=int, default=None,
                   help="concurrent job slots (default: "
                        "settings.serve_workers)")
    p.add_argument("--state-dir", default=None,
                   help="job/state directory (default: "
                        "<scratch_root>/serve)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    daemon = ServeDaemon(port=args.port, host=args.host,
                         workers=args.workers, state_dir=args.state_dir)
    if daemon.start() is None:
        return 1
    stop_evt = threading.Event()

    def _on_signal(signum, frame):
        stop_evt.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print("dampr_tpu_torch serve listening on http://{}:{} ({} worker "
          "slot(s), pid {})".format(daemon.host, daemon.port,
                                    daemon.workers, os.getpid()),
          flush=True)
    while not stop_evt.is_set():
        stop_evt.wait(0.2)
    daemon.drain()
    daemon.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
