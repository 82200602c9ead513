"""Stdlib client of the serve daemon: :class:`ServeClient` and
:class:`RemoteJob`, behind ``PBase.submit(url)``.

Port of ``dampr_tpu/serve/client.py``, whole.  A submission is validated
twice: here, before any byte travels (the admission gate's pre-flight,
with its multi-process promotion, so an unpicklable capture fails fast
with the coded ``DTA401`` diagnostic), and at the daemon's door.  A
worker never sees an invalid plan.

``RemoteJob.result()`` unpickles the exact bytes the worker wrote
(``result.pkl``, streamed verbatim through the daemon), so a served
run's records are a local ``run()``'s.
"""

import json
import pickle
import time
import urllib.error
import urllib.request

from . import wire as _wire


class SubmitError(RuntimeError):
    """A submission the daemon (or the client-side pre-flight) refused.
    ``reason`` is the machine-readable rejection class (``wire``,
    ``invalid``, ``budget``, ``queue-full``, ``draining``, ...);
    ``diagnostics`` carries the coded pre-flight records when the
    rejection was an admission-gate validation failure."""

    def __init__(self, message, reason=None, diagnostics=None):
        super(SubmitError, self).__init__(message)
        self.reason = reason
        self.diagnostics = diagnostics or []


class RemoteJob(object):
    """Handle onto one submitted job (or a coalesced follower)."""

    def __init__(self, client, job_id, state, primary=None,
                 fingerprint=None):
        self.client = client
        self.id = job_id
        self.state = state
        self.primary = primary
        self.fingerprint = fingerprint
        self._row = None

    def poll(self):
        """Refresh and return this job's /jobs row."""
        self._row = self.client._get_json("/jobs/" + self.id)
        self.state = self._row.get("state", self.state)
        return self._row

    def wait(self, timeout_s=300.0, interval_s=0.1):
        """Block until the job reaches a terminal state; returns the
        final row.  Raises :class:`TimeoutError` at the deadline."""
        deadline = time.time() + timeout_s
        while True:
            row = self.poll()
            if self.state in ("done", "failed", "cancelled", "rejected"):
                return row
            if time.time() >= deadline:
                raise TimeoutError(
                    "job {} still {!r} after {:.1f}s".format(
                        self.id, self.state, timeout_s))
            time.sleep(interval_s)

    def result_bytes(self, timeout_s=300.0):
        """The worker's result.pkl bytes, verbatim.  Waits for
        completion; raises :class:`SubmitError` when the job failed."""
        self.wait(timeout_s=timeout_s)
        status, body, ctype = self.client._get_raw("/result/" + self.id)
        if status == 200:
            return body
        try:
            doc = json.loads(body.decode("utf-8"))
        except ValueError:
            doc = {"error": body[:200].decode("utf-8", "replace")}
        raise SubmitError(
            "job {} {}: {}".format(self.id, self.state,
                                   doc.get("error", "no result")),
            reason=doc.get("state") or self.state)

    def result(self, timeout_s=300.0):
        """The job's output records: the list of ``(key, value)`` pairs
        a local ``run().read()`` of the same plan yields."""
        return pickle.loads(self.result_bytes(timeout_s=timeout_s))

    def read(self, timeout_s=300.0):
        """Values only (mirrors ``ValueEmitter.stream`` ordering)."""
        return [v for _k, v in self.result(timeout_s=timeout_s)]

    def cancel(self):
        doc = self.client._post_json("/cancel/" + self.id, b"")
        self.state = doc.get("state", self.state)
        return doc


class ServeClient(object):
    """HTTP client onto one daemon.  ``url`` is the base, e.g.
    ``http://127.0.0.1:9400``."""

    def __init__(self, url, timeout_s=30.0):
        self.url = url.rstrip("/")
        self.timeout_s = timeout_s

    # -- transport -----------------------------------------------------------
    def _request(self, method, path, body=None):
        req = urllib.request.Request(
            self.url + path, data=body, method=method,
            headers={"Content-Type": "application/json"} if body is not None
            else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                return (resp.status, resp.read(),
                        resp.headers.get("Content-Type", ""))
        except urllib.error.HTTPError as e:
            return e.code, e.read(), e.headers.get("Content-Type", "")

    def _get_raw(self, path):
        return self._request("GET", path)

    def _get_json(self, path):
        status, body, _ctype = self._request("GET", path)
        doc = json.loads(body.decode("utf-8"))
        if status != 200:
            raise SubmitError(doc.get("error", "HTTP {}".format(status)),
                              reason=doc.get("reason"))
        return doc

    def _post_json(self, path, body):
        status, raw, _ctype = self._request("POST", path, body=body)
        doc = json.loads(raw.decode("utf-8"))
        if status != 200:
            raise SubmitError(doc.get("error", "HTTP {}".format(status)),
                              reason=doc.get("reason"),
                              diagnostics=doc.get("diagnostics"))
        return doc

    # -- protocol ------------------------------------------------------------
    def submit(self, pipeline, tenant="default", reuse="auto",
               timeout_s=None, label=None, validate=True):
        """Ship a composed pipeline (a DSL handle, or a raw
        ``(graph, source)`` pair) to the daemon; returns a
        :class:`RemoteJob`.

        ``validate=True`` (default) runs the admission pre-flight
        client-side first — same checks, same coded diagnostics, no
        network round-trip for a plan the daemon would bounce anyway.
        ``reuse="off"`` opts this job out of the materialization cache
        AND of in-flight coalescing (it always gets its own run).
        """
        graph, source = self._plan_of(pipeline)
        if validate:
            from ..analyze import validate as _validate

            diags = _validate.validate_graph(
                graph, num_processes=2, probe_traceable=False,
                probe_assoc=True, probe_pickle=True)
            errors = [d for d in diags if d.severity == "error"]
            if errors:
                raise SubmitError(
                    "plan failed pre-flight validation: " + "; ".join(
                        "{}: {}".format(d.code, d.message)
                        for d in errors),
                    reason="invalid",
                    diagnostics=[d.to_dict() for d in errors])
        try:
            payload = _wire.encode(graph, source)
        except _wire.WireError as e:
            raise SubmitError(str(e), reason="wire")
        import base64

        request = {"tenant": tenant, "plan":
                   base64.b64encode(payload).decode("ascii"),
                   "reuse": reuse}
        if timeout_s is not None:
            request["timeout_s"] = timeout_s
        if label:
            request["label"] = label
        doc = self._post_json(
            "/submit", json.dumps(request).encode("utf-8"))
        return RemoteJob(self, doc["job"], doc.get("state", "queued"),
                         primary=doc.get("primary"),
                         fingerprint=doc.get("fingerprint"))

    @staticmethod
    def _plan_of(pipeline):
        graph = getattr(getattr(pipeline, "pmer", None), "graph", None)
        source = getattr(pipeline, "source", None)
        if graph is not None and source is not None:
            return graph, source
        try:
            graph, source = pipeline
            return graph, source
        except (TypeError, ValueError):
            raise SubmitError(
                "cannot submit {!r}: expected a composed pipeline handle "
                "or a (graph, source) pair".format(type(pipeline).__name__),
                reason="wire")

    # -- telemetry -----------------------------------------------------------
    def jobs(self):
        return self._get_json("/jobs")

    def health(self):
        return self._get_json("/healthz")

    def metrics(self):
        _status, body, _ctype = self._get_raw("/metrics")
        return body.decode("utf-8")

    def drain(self):
        return self._post_json("/drain", b"")
