"""Per-tenant fair scheduling for the serve daemon.

Port of ``dampr_tpu/serve/scheduler.py``, whole: plain state and
transitions, which the daemon serializes under its own lock.

- **Admission** (at submit) charges the job's estimated input bytes
  (:func:`.wire.estimate_input_bytes`) against the tenant's byte budget;
  a tenant whose queued and running jobs already reserve it is rejected
  with a coded event instead of queued forever.  The reservation is held
  until the job is terminal, so a cancelled job releases it at once.
- **Dispatch** (when a worker slot frees) is deficit round-robin in
  bytes: each pass funds every tenant with queued work by ``quantum`` and
  dispatches its head job once the deficit covers the job's cost, so a
  tenant flooding small jobs cannot starve one with a large job, nor the
  other way round.
- **In-flight dedupe** rides the submission fingerprint: a non-volatile
  fingerprint equal to a queued or running job's attaches the new
  submission as a follower of that primary (no queue entry, no
  reservation, one run; both clients read the same result bytes).
"""

import collections
import time

#: Job lifecycle.  ``coalesced`` is terminal-by-proxy: the follower's
#: outcome IS its primary's (resolved through ``Job.primary``).
STATES = ("queued", "running", "done", "failed", "cancelled", "rejected",
          "coalesced")
TERMINAL = ("done", "failed", "cancelled", "rejected")


class AdmissionError(Exception):
    """Submission refused at the door.  ``reason`` is the machine field
    the coded ``serve-reject`` event and the HTTP response carry."""

    def __init__(self, reason, message):
        super(AdmissionError, self).__init__(message)
        self.reason = reason


class Job(object):
    """One submission's full record (the /jobs row)."""

    def __init__(self, job_id, tenant, fingerprint, cost, payload=None,
                 options=None):
        self.id = job_id
        self.tenant = tenant
        self.fingerprint = fingerprint
        self.cost = int(cost)
        self.payload = payload          # wire bytes until dispatched
        self.options = dict(options or {})
        self.state = "queued"
        self.primary = None             # job id this one coalesced onto
        self.followers = []
        self.submitted_at = time.time()
        self.started_at = None
        self.finished_at = None
        self.error = None
        self.diagnostics = []
        self.exit_code = None
        self.run_name = None
        self.job_dir = None
        self.crashdump = None
        self.result_meta = {}
        self.cancel_requested = False

    @property
    def queue_wait_s(self):
        if self.started_at is not None:
            return self.started_at - self.submitted_at
        if self.state == "queued":
            return time.time() - self.submitted_at
        return None

    @property
    def wall_s(self):
        if self.started_at is None:
            return None
        return (self.finished_at or time.time()) - self.started_at

    def to_row(self):
        meta = self.result_meta or {}
        reuse = meta.get("reuse") or {}
        row = {
            "job": self.id,
            "tenant": self.tenant,
            "state": self.state,
            "fingerprint": (self.fingerprint or "")[:16],
            "cost_bytes": self.cost,
            "submitted_at": self.submitted_at,
            "queue_wait_s": self.queue_wait_s,
            "wall_s": self.wall_s,
            "reuse_hits": reuse.get("hits"),
            "records": meta.get("records"),
            "primary": self.primary,
            "coalesced": len(self.followers),
            "error": self.error,
            "exit_code": self.exit_code,
            "crashdump": self.crashdump,
        }
        if self.diagnostics:
            row["diagnostics"] = list(self.diagnostics)
        return row


class _Tenant(object):
    def __init__(self, name, budget):
        self.name = name
        self.budget = int(budget)
        self.queue = collections.deque()
        self.deficit = 0
        self.reserved = 0
        self.counts = collections.Counter()


class Scheduler(object):
    def __init__(self, tenant_budget, quantum, queue_depth):
        self.tenant_budget = int(tenant_budget)
        self.quantum = max(1, int(quantum))
        self.queue_depth = int(queue_depth)
        self.tenants = {}
        self._rotation = []    # tenant visit order (stable)
        self._cursor = 0       # DRR pointer, survives across dispatches
        self._active_fp = {}   # fingerprint -> primary Job (queued/running)

    def tenant(self, name):
        st = self.tenants.get(name)
        if st is None:
            st = self.tenants[name] = _Tenant(name, self.tenant_budget)
            self._rotation.append(name)
        return st

    # -- admission ----------------------------------------------------------
    def coalesce_target(self, fingerprint):
        """The in-flight primary an identical submission coalesces onto,
        or None.  Volatile fingerprints never match (the caller checks)."""
        job = self._active_fp.get(fingerprint)
        if job is not None and job.state in ("queued", "running"):
            return job
        return None

    def admit(self, job):
        """Queue ``job``, reserving its cost against the tenant budget.
        Raises :class:`AdmissionError` when the budget or queue depth is
        exhausted."""
        st = self.tenant(job.tenant)
        if len(st.queue) >= self.queue_depth:
            raise AdmissionError(
                "queue-full",
                "tenant {!r} already has {} queued job(s) (limit {})"
                .format(job.tenant, len(st.queue), self.queue_depth))
        if st.reserved + job.cost > st.budget:
            raise AdmissionError(
                "budget",
                "tenant {!r} byte budget exhausted: {} reserved + {} "
                "requested > {} budget".format(
                    job.tenant, st.reserved, job.cost, st.budget))
        st.reserved += job.cost
        st.queue.append(job)
        st.counts["admitted"] += 1
        if job.fingerprint and job.fingerprint not in self._active_fp:
            self._active_fp[job.fingerprint] = job
        return st

    def attach_follower(self, primary, follower):
        follower.state = "coalesced"
        follower.primary = primary.id
        primary.followers.append(follower.id)
        self.tenant(follower.tenant).counts["coalesced"] += 1

    # -- dispatch -----------------------------------------------------------
    def next_job(self):
        """Deficit-round-robin pick: the next dispatchable job, or None
        when every queue is empty.  Terminates because each full pass
        funds every live deficit by ``quantum`` > 0."""
        live = [n for n in self._rotation if self.tenants[n].queue]
        if not live:
            return None
        n = len(self._rotation)
        while True:
            name = self._rotation[self._cursor % n]
            self._cursor += 1
            st = self.tenants[name]
            if not st.queue:
                continue
            st.deficit += self.quantum
            head = st.queue[0]
            if st.deficit >= head.cost:
                st.queue.popleft()
                st.deficit -= head.cost
                if not st.queue:
                    # classic DRR: an emptied queue forfeits its credit —
                    # idle tenants must not bank allowance.
                    st.deficit = 0
                return head

    # -- terminal transitions -----------------------------------------------
    def remove_queued(self, job):
        """Drop a still-queued job (cancellation path).  Returns True
        when it was found in its tenant's queue."""
        st = self.tenant(job.tenant)
        try:
            st.queue.remove(job)
        except ValueError:
            return False
        return True

    def release(self, job):
        """Return ``job``'s reservation to its tenant and retire its
        fingerprint from the dedupe index.  Idempotent per job."""
        st = self.tenant(job.tenant)
        if job.cost > 0:
            st.reserved = max(0, st.reserved - job.cost)
            job.cost = 0  # released exactly once
        if self._active_fp.get(job.fingerprint) is job:
            del self._active_fp[job.fingerprint]
        st.counts[job.state] += 1

    # -- telemetry ----------------------------------------------------------
    def stats(self):
        """Per-tenant counters for /jobs and /metrics."""
        out = {}
        for name in self._rotation:
            st = self.tenants[name]
            out[name] = {
                "queued": len(st.queue),
                "reserved_bytes": st.reserved,
                "budget_bytes": st.budget,
                "deficit_bytes": st.deficit,
                "counts": dict(st.counts),
            }
        return out
