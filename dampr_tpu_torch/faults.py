"""Fault injection, failure classification, and quarantine plumbing.

Port of ``dampr_tpu/faults.py``, whole: the same site catalog, spec
grammar, per-site seeded schedules (one spec and seed fire on the same
invocations in both packages), classification, backoff, quarantine and
event sidecar.  Failure is a tested code path, in two halves:

**Injection** — a registry of named fault sites threaded through the
hot paths (spill frame write/read, UDF invocation, exchange steps,
device dispatch, checkpoint persist, observability tick loops, and a
rank-kill site for multi-process tests), driven by a seeded,
schedule-based plan so chaos runs are exactly reproducible::

    DAMPR_TPU_TORCH_FAULTS="spill_write:p=0.01;fold:nth=3"

Each entry names a site plus firing rules (``p=`` per-invocation
probability from a per-site seeded RNG, ``nth=`` the 1-based invocation
that faults, ``every=`` a period, ``times=`` a budget, ``match=`` a
substring content key so a *specific record* fails deterministically,
``rank=`` a process-rank filter) and an action (raise a classified
fault — ``kind=transient|deterministic|fatal``, default transient —
or ``sleep_ms=`` a stall, or ``exit=`` an ``os._exit`` code: the
rank-kill used by the multi-process chaos tests, which flushes the
flight recorder first so the killed rank still leaves a crashdump).

Zero overhead when disabled: every site is one module-global None-check
(:func:`check` / :func:`check_records`), the same contract as
:mod:`.obs.trace`.

**Classification** — :func:`classify` buckets any exception for the
retry layers:

- ``transient`` (flaky IO: ``OSError`` and friends, plus injected
  transients): worth an in-place retry, *with* exponential backoff +
  jitter (:func:`backoff`);
- ``deterministic`` (everything else — a UDF bug, a poison record):
  retried without backoff for legacy compatibility by the job loop,
  and the batched-UDF path first tries to *bisect and quarantine* the
  offending records (:class:`Quarantine`, ``settings.max_quarantined``);
- ``fatal`` (``MemoryError``, ``KeyboardInterrupt``, ``SystemExit``,
  quarantine-budget overflow, injected fatals): never retried — not by
  the job loop, not by ``run(resume="auto")``.

**Fault events** — cross-run memory for failures that kill the process
before stats can land: one JSONL sidecar per run name
(``<scratch_root>/<run>/faults.jsonl``, bounded, O_APPEND crash-safe like
the history corpus).  In the JAX package the exchange watchdog writes it
and the shuffle planner reads it; the port runs on one card, so nothing
here writes an ``exchange_timeout`` yet.

Torch's ``OutOfMemoryError`` is a ``RuntimeError``: it classifies as
deterministic, as an XLA runtime error does in the JAX package.

See ``docs/robustness.md`` for the full site catalog and semantics.
"""

import json
import logging
import os
import random
import threading
import time

from . import settings

log = logging.getLogger("dampr_tpu_torch.faults")

EVENTS_FILE = "faults.jsonl"
QUARANTINE_FILE = "quarantine.jsonl"

#: Cap on retained fault-event lines per run (oldest rewritten away).
EVENTS_CAP = 256

#: The documented fault-site catalog (docs/robustness.md keeps the
#: prose table; tests assert the two stay in sync).  An unknown site in
#: a plan is tolerated with a one-time warning — forward compatibility
#: beats a hard failure in a chaos harness.
SITES = (
    "spill_write",      # io/writer.py worker + storage sync spill
    "spill_read",       # io/frames.py frame read/decompress
    "udf",              # runner batched-UDF chain (match= keys records)
    "fold",             # runner map-side partial/final folds
    "exchange_step",    # parallel/exchange.py per collective step
    "device_dispatch",  # ops/lower.py program dispatch
    "checkpoint_persist",  # resume.py manifest/block persistence
    "rank_kill",        # exchange step entry; exit= kills the process
    "sampler_tick",     # obs/sampler.py loop (slow-stop shutdown tests)
    "progress_tick",    # obs/progress.py loop
    "overlap_produce",  # runner._overlap_stream producer (race widener)
    "cache_read",       # plan/reuse.py manifest/block reads (degrade path)
    "stream_publish",   # runner pipelined publish hook (streamed edges)
)


# -- injected fault types ----------------------------------------------------

class InjectedFault(Exception):
    """Base of every injected fault (site name on ``.site``)."""

    site = None


class TransientInjectedFault(InjectedFault, OSError):
    """Injected flaky-IO failure: classified ``transient`` (retryable
    with backoff) by construction — it subclasses OSError so code that
    catches real IO errors treats it identically."""


class DeterministicInjectedFault(InjectedFault):
    """Injected poison failure: same inputs always fail (the quarantine
    path's test vehicle)."""


class FatalInjectedFault(InjectedFault):
    """Injected unrecoverable failure: no retry layer may absorb it."""


class QuarantineOverflow(Exception):
    """More poison records than ``settings.max_quarantined`` allows —
    classified fatal (retrying re-bisects into the same wall)."""


_KIND_EXC = {
    "transient": TransientInjectedFault,
    "deterministic": DeterministicInjectedFault,
    "fatal": FatalInjectedFault,
}


# -- classification ----------------------------------------------------------

def classify(exc):
    """``"transient"`` | ``"deterministic"`` | ``"fatal"`` for any
    exception.  Transient = flaky-IO shaped (worth an in-place retry
    with backoff); fatal = never retried by any layer; everything else
    is deterministic (a UDF/data failure — the job retry loop still
    retries it for legacy compatibility, but without backoff, and the
    quarantine path handles it first where it applies)."""
    if isinstance(exc, FatalInjectedFault):
        return "fatal"
    if isinstance(exc, (MemoryError, KeyboardInterrupt, SystemExit,
                        GeneratorExit, QuarantineOverflow)):
        return "fatal"
    if isinstance(exc, TransientInjectedFault):
        return "transient"
    if isinstance(exc, (OSError, TimeoutError, ConnectionError,
                        InterruptedError)):
        # IOError == OSError on py3; TimeoutError/ConnectionError are
        # OSError subclasses but named for readers grepping the policy.
        return "transient"
    return "deterministic"


def backoff(attempt, rng=random):
    """Retry delay (seconds) for the given 0-based attempt: full-jitter
    exponential backoff — uniform over ``[0, min(cap, base * 2^n)]``
    (the AWS-architecture-blog scheme: decorrelates retry storms while
    keeping the expected delay half the deterministic ladder)."""
    base = max(1, settings.retry_backoff_ms)
    cap = max(base, settings.retry_backoff_max_ms)
    span = min(cap, base * (1 << min(int(attempt), 20)))
    return rng.uniform(0.0, span) / 1000.0


# -- the injection plan ------------------------------------------------------

class FaultSpecError(ValueError):
    """Malformed fault spec."""


class SiteRule(object):
    """Firing rules + action for one site.  Thread-safe: invocation
    counting and the seeded RNG sit behind one lock (fault checks are
    off the per-record hot path, so the lock cost is irrelevant)."""

    __slots__ = ("site", "p", "nth", "every", "times", "kind", "match",
                 "rank", "sleep_ms", "exit_code", "duration_ms",
                 "invocations", "injected", "_t0", "_rng", "_lock")

    def __init__(self, site, seed=0, p=None, nth=None, every=None,
                 times=None, kind="transient", match=None, rank=None,
                 sleep_ms=None, exit_code=None, duration_ms=None):
        self.site = site
        self.p = p
        self.nth = nth
        self.every = every
        self.times = times
        if times is None:
            # nth fires once by default; p/every/match keep firing.
            self.times = 1 if nth is not None else None
        if kind not in _KIND_EXC:
            raise FaultSpecError(
                "site {}: unknown kind {!r} (transient/deterministic/"
                "fatal)".format(site, kind))
        self.kind = kind
        self.match = match
        self.rank = rank
        self.sleep_ms = sleep_ms
        self.exit_code = exit_code
        # Windowed firing (the `slow` duty-cycle modeling a rank that is
        # slow for a while then RECOVERS — the straggler-mitigation
        # disengage test vehicle): the rule only fires within
        # ``duration_ms`` of its first invocation; past the window the
        # site goes quiet (invocations still count).
        self.duration_ms = duration_ms
        self._t0 = None
        self.invocations = 0
        self.injected = 0
        # Per-site seeded stream: the schedule replays exactly under the
        # same seed regardless of which other sites fired.
        self._rng = random.Random(
            "{}:{}".format(seed, site).encode("utf-8"))
        self._lock = threading.Lock()

    def _matches(self, record):
        if self.match is None:
            return True
        if record is None:
            return False
        try:
            return self.match in repr(record)
        except Exception:
            return False

    def should_fire(self, record=None):
        """Count one invocation and decide.  ``match=`` rules are
        content-keyed (the invocation counter still advances, but only
        matching records can fire — and they ALWAYS fire while the
        ``times`` budget lasts, so a poison record fails
        deterministically on every re-execution/bisect probe)."""
        with self._lock:
            if self.rank is not None and self.rank != _process_rank():
                return False
            self.invocations += 1
            if self.duration_ms is not None:
                now = time.monotonic()
                if self._t0 is None:
                    self._t0 = now
                if (now - self._t0) * 1000.0 > self.duration_ms:
                    return False  # slow window over: the site recovered
            if self.times is not None and self.injected >= self.times:
                return False
            if self.match is not None:
                fire = self._matches(record)
            elif self.nth is not None:
                fire = self.invocations == self.nth
            elif self.every is not None:
                fire = self.invocations % max(1, self.every) == 0
            elif self.p is not None:
                fire = self._rng.random() < self.p
            else:
                fire = True
            if fire:
                self.injected += 1
            return fire

    def describe(self):
        out = {"site": self.site, "kind": self.kind}
        for k in ("p", "nth", "every", "times", "match", "rank",
                  "sleep_ms", "exit_code", "duration_ms"):
            v = getattr(self, k)
            if v is not None:
                out[k] = v
        return out


def _process_rank():
    """This process's rank: the port runs one process, rank 0."""
    return 0


def _parse_value(key, val):
    if key == "p":
        return float(val)
    if key in ("nth", "every", "times", "rank", "sleep_ms", "exit",
               "duration_ms"):
        return int(val)
    return val


class FaultPlan(object):
    """Parsed injection schedule: ``{site: SiteRule}`` plus the seed.

    Spec grammar (fully deterministic under one seed)::

        spec  := entry (';' entry)*
        entry := 'seed=' INT | SITE ':' kv (',' kv)*
        kv    := ('p'|'nth'|'every'|'times'|'rank'|'sleep_ms'|'exit'
                  |'duration_ms') '=' NUM
               | 'kind' '=' ('transient'|'deterministic'|'fatal')
               | 'match' '=' TEXT

    ``duration_ms`` windows any rule to the first N ms after its first
    invocation — with ``sleep_ms`` it models a rank that is slow for a
    while then recovers (the straggler-mitigation disengage vehicle).
    """

    def __init__(self, spec, seed=None):
        self.spec = spec
        self.seed = 0 if seed is None else int(seed)
        self._from_settings = False  # set by configure_for_run
        self.rules = {}
        entries = [e.strip() for e in (spec or "").split(";") if e.strip()]
        # Pass 1: the seed entry applies to every site regardless of
        # position (a trailing ';seed=7' must not reseed half the plan).
        body = []
        for entry in entries:
            if entry.startswith("seed=") and ":" not in entry:
                self.seed = int(entry.split("=", 1)[1])
                continue
            body.append(entry)
        for entry in body:
            if ":" not in entry:
                raise FaultSpecError(
                    "fault entry {!r}: expected 'site:key=val,...'"
                    .format(entry))
            site, _colon, rest = entry.partition(":")
            site = site.strip()
            kwargs = {}
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                if "=" not in kv:
                    raise FaultSpecError(
                        "fault entry {!r}: bad rule {!r}".format(entry, kv))
                k, _eq, v = kv.partition("=")
                k = k.strip()
                try:
                    kwargs[k] = _parse_value(k, v.strip())
                except ValueError:
                    raise FaultSpecError(
                        "fault entry {!r}: bad value for {!r}".format(
                            entry, k))
            exit_code = kwargs.pop("exit", None)
            if site not in SITES:
                log.warning("fault plan names unknown site %r (known: %s)"
                            " — kept anyway", site, ", ".join(SITES))
            try:
                self.rules[site] = SiteRule(
                    site, seed=self.seed, exit_code=exit_code, **kwargs)
            except TypeError as e:
                raise FaultSpecError(
                    "fault entry {!r}: {}".format(entry, e))

    # -- firing --------------------------------------------------------------
    def _fire(self, rule, record=None):
        count_injected(rule.site)
        from .obs import trace as _trace

        _trace.instant("fault", "inject:{}".format(rule.site),
                       site=rule.site, kind=rule.kind)
        if rule.exit_code is not None:
            # Rank-kill: flush the flight recorder so the killed process
            # still leaves a schema-valid crashdump, then die hard — the
            # whole point is an abrupt, unannounced death.
            from .obs import flightrec as _flightrec

            log.error("fault injection: killing process (site=%s, "
                      "exit=%d)", rule.site, rule.exit_code)
            _flightrec.flush_active(
                "fault-injected-kill",
                FatalInjectedFault("rank kill at {}".format(rule.site)))
            os._exit(rule.exit_code)
        if rule.sleep_ms is not None:
            log.warning("fault injection: stalling %s for %d ms",
                        rule.site, rule.sleep_ms)
            time.sleep(rule.sleep_ms / 1000.0)
            return
        exc = _KIND_EXC[rule.kind](
            "injected {} fault at site {!r} (injection #{})".format(
                rule.kind, rule.site, rule.injected))
        exc.site = rule.site
        raise exc

    def check(self, site, record=None):
        rule = self.rules.get(site)
        if rule is not None and rule.should_fire(record):
            self._fire(rule, record)

    def check_records(self, site, keys, values):
        """Batch form for record-keyed sites: a ``match=`` rule scans
        the batch and fires on the first poisoned record; rules without
        ``match`` count the call as ONE invocation (batch granularity)."""
        rule = self.rules.get(site)
        if rule is None:
            return
        if rule.match is None:
            if rule.should_fire():
                self._fire(rule)
            return
        for k, v in zip(keys, values):
            if rule.should_fire((k, v)):
                self._fire(rule, (k, v))

    def counts(self):
        return {site: r.injected for site, r in self.rules.items()
                if r.injected}

    def describe(self):
        return {"spec": self.spec, "seed": self.seed,
                "sites": [r.describe() for r in self.rules.values()]}


# -- module-level lifecycle (mirrors obs.trace) ------------------------------

_active = None


def configure(spec=None):
    """Install a plan from ``spec`` (default: ``settings.faults`` /
    env ``DAMPR_TPU_TORCH_FAULTS``).  Empty spec clears.  Returns the
    active plan or None."""
    global _active
    if spec is None:
        spec = settings.faults
    if not spec:
        _active = None
        return None
    _active = FaultPlan(spec)
    log.warning("fault injection ACTIVE: %s", spec)
    return _active


def configure_for_run():
    """Per-run (re)installation: when ``settings.faults`` carries a
    spec, every run starts a FRESH plan — per-run invocation counters
    make each run's schedule identical, which is what lets the chaos CI
    pin byte-identical results.  When ``settings.faults`` is cleared, a
    previously settings-installed plan is cleared with it (the
    documented "empty = injection fully disabled" contract); a plan a
    test installed directly via :func:`install` is left alone."""
    global _active
    if settings.faults:
        plan = configure(settings.faults)
        plan._from_settings = True
    elif _active is not None and getattr(_active, "_from_settings",
                                         False):
        _active = None


def install(plan):
    global _active
    _active = plan


def clear():
    global _active
    _active = None


def active():
    return _active


def enabled():
    return _active is not None


def check(site, record=None):
    """One-None-check fault site.  No-op unless a plan is installed."""
    p = _active
    if p is not None:
        p.check(site, record)


def check_records(site, keys, values):
    p = _active
    if p is not None:
        p.check_records(site, keys, values)


# -- retry / injection counters (process-cumulative; runner snapshots) -------

_counter_lock = threading.Lock()
injected_counts = {}
io_retry_counts = {}
io_backoff_seconds = 0.0


def count_injected(site):
    with _counter_lock:
        injected_counts[site] = injected_counts.get(site, 0) + 1


def count_io_retry(kind, delay=0.0):
    """One transient IO retry (``spill_write`` / ``spill_read`` /
    ``checkpoint_persist``) absorbed by an in-place retry loop, plus
    the backoff it is about to sleep — IO-only retry storms must show
    their cost in ``backoff_seconds``, not just a count."""
    global io_backoff_seconds
    with _counter_lock:
        io_retry_counts[kind] = io_retry_counts.get(kind, 0) + 1
        io_backoff_seconds += delay


def counters_snapshot():
    with _counter_lock:
        return dict(injected_counts), dict(io_retry_counts), \
            io_backoff_seconds


def counters_delta(snap):
    """(injected, io_retries, io_backoff_seconds) deltas since ``snap``
    — THIS run's share of the process-cumulative counters."""
    if snap is None:
        return {}, {}, 0.0
    inj0, io0, bk0 = snap
    with _counter_lock:
        inj = {k: v - inj0.get(k, 0) for k, v in injected_counts.items()
               if v - inj0.get(k, 0) > 0}
        io = {k: v - io0.get(k, 0) for k, v in io_retry_counts.items()
              if v - io0.get(k, 0) > 0}
        bk = max(0.0, io_backoff_seconds - bk0)
    return inj, io, bk


def retry_io(fn, kind, retries=None):
    """Run ``fn()`` retrying TRANSIENT failures in place with backoff
    (``settings.io_retries`` by default).  Deterministic and fatal
    failures propagate immediately — a corrupt frame or a dead disk is
    not healed by retrying.  Counts absorbed retries (and the backoff
    seconds slept) per ``kind``."""
    budget = settings.io_retries if retries is None else retries
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:
            if classify(e) != "transient" or attempt >= budget:
                raise
            delay = backoff(attempt)
            count_io_retry(kind, delay)
            from .obs import trace as _trace

            _trace.instant("fault", "retry:{}".format(kind),
                           attempt=attempt + 1, kind="transient")
            log.warning("transient %s failure (attempt %d/%d), retrying "
                        "in %.0f ms: %s", kind, attempt + 1, budget + 1,
                        delay * 1000, e)
            time.sleep(delay)
            attempt += 1


# -- run context (exchange watchdog attribution) -----------------------------

#: Display/attribution-only view of the run the CURRENT process is
#: executing (single-writer: the runner's sequential stage walk).  The
#: exchange watchdog reads it to tag fault events with run + stage.
run_context = {"run": None, "stage": None}


def set_context(run=None, stage=None):
    run_context["run"] = run
    run_context["stage"] = stage


# -- shared JSONL sidecar plumbing -------------------------------------------

def _safe_run_dir(run_name):
    return os.path.join(settings.scratch_root,
                        str(run_name).replace("/", "_"))


def _append_jsonl(path, lines):
    """Crash-safe line appends: one ``O_APPEND`` fd, one write per line
    (a process dying mid-write corrupts at most its own line).  The
    caller owns any locking and pre-serialized the lines."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
    try:
        for line in lines:
            os.write(fd, (line + "\n").encode("utf-8", "backslashreplace"))
    finally:
        os.close(fd)


def _load_jsonl(path, keep=None):
    """Tolerant line-validated load: unparsable lines are skipped,
    never fatal; ``keep`` filters parsed dicts."""
    out = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and (keep is None or keep(rec)):
                    out.append(rec)
    except OSError:
        return []
    return out


# -- quarantine sink ---------------------------------------------------------


def quarantine_path(run_name):
    return os.path.join(_safe_run_dir(run_name), QUARANTINE_FILE)


class Quarantine(object):
    """Per-run poison-record sink, bounded by ``settings.max_quarantined``.

    Accounting is **attempt-scoped**: each job collects the records its
    bisect isolated in a local :class:`QuarantineAttempt` and commits
    them only when the attempt SUCCEEDS.  A retried job (its first
    attempt's outputs rolled back by ``store.attempt()``) re-encounters
    the same poison records and re-records them from scratch — the
    failed attempt never committed, so nothing double-counts — while
    *genuinely duplicate* poison records (same bytes, distinct record
    instances) each count and each land in the sink, so the budget
    bounds real data loss, not distinct reprs.

    Over-budget at record time or commit time raises
    :class:`QuarantineOverflow` (fatal; the run fails fast with the
    original failure chained).  A fresh run under the same name
    truncates the previous run's sink (the file describes THIS run)."""

    def __init__(self, run_name, limit):
        self.run = run_name
        self.limit = max(0, int(limit))
        self.path = quarantine_path(run_name)
        self.count = 0  # committed records (successful attempts only)
        self.records = []  # committed record dicts (bounded by limit):
        #                    lets an auto-resume retry adopt this state
        self._lock = threading.Lock()
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            if os.path.exists(self.path):
                os.unlink(self.path)
        except OSError:
            pass

    def rewrite_sink(self):
        """Re-materialize the sink file from the committed in-memory
        records — the ``run(resume="auto")`` path: a fresh retry
        runner's Quarantine.__init__ truncated the file, but the prior
        attempt's committed quarantines (whose stages may now restore
        from checkpoints without re-running) must survive in both the
        audit trail and the budget."""
        with self._lock:
            try:
                tmp = self.path + ".tmp"
                with open(tmp, "w", encoding="utf-8",
                          errors="backslashreplace") as f:
                    for rec in self.records:
                        f.write(json.dumps(rec, default=str) + "\n")
                os.replace(tmp, self.path)
            except OSError:
                log.warning("quarantine sink rewrite failed",
                            exc_info=True)

    def attempt(self):
        """A fresh per-job-attempt recorder."""
        return QuarantineAttempt(self)

    def precheck(self, local_pending, stage, exc):
        """Budget gate at record time (optimistic: concurrent jobs'
        uncommitted records are invisible; commit re-checks)."""
        with self._lock:
            if self.count + local_pending >= self.limit:
                raise QuarantineOverflow(
                    "stage {}: quarantine budget exhausted "
                    "(settings.max_quarantined={}) — failing fast with "
                    "the original error".format(stage, self.limit)) from exc

    def commit(self, records):
        """Land one successful attempt's quarantined records: count
        them, append the sink lines, re-check the budget (two jobs may
        have raced under ``precheck``'s optimistic gate)."""
        if not records:
            return
        with self._lock:
            if self.count + len(records) > self.limit:
                raise QuarantineOverflow(
                    "quarantine budget exhausted at commit "
                    "(settings.max_quarantined={}, {} committed, {} "
                    "landing)".format(self.limit, self.count,
                                      len(records)))
            self.count += len(records)
            self.records.extend(records)
            n = self.count
            try:
                _append_jsonl(self.path,
                              [json.dumps(rec, default=str)
                               for rec in records])
            except OSError:
                log.warning("quarantine sink write failed", exc_info=True)
        log.warning(
            "quarantined %d poison record(s) (%d/%d total) -> %s",
            len(records), n, self.limit, self.path)


class QuarantineAttempt(object):
    """One job attempt's local quarantine recorder (single-threaded:
    owned by the job closure)."""

    __slots__ = ("_q", "records")

    def __init__(self, quarantine):
        self._q = quarantine
        self.records = []

    def add(self, stage, key, value, exc):
        self._q.precheck(len(self.records), stage, exc)
        self.records.append({
            "stage": stage,
            "key": repr(key)[:500],
            "value": repr(value)[:500],
            "error": type(exc).__name__,
            "message": str(exc)[:500],
            "ts": round(time.time(), 3),
        })
        from .obs import trace as _trace

        _trace.instant("fault", "quarantine", stage=stage,
                       error=type(exc).__name__)
        log.warning(
            "stage %s: isolated poison record (%s: %s) — lands in the "
            "sink when this job attempt commits", stage,
            type(exc).__name__, str(exc)[:200])

    def commit(self):
        self._q.commit(self.records)
        self.records = []


def load_quarantine(run_name):
    """Every quarantined-record line for a run (empty on none)."""
    return _load_jsonl(quarantine_path(run_name))


# -- fault-event sidecar (cross-run memory for process-killing faults) -------

def events_path(run_name):
    return os.path.join(_safe_run_dir(run_name), EVENTS_FILE)


_events_lock = threading.Lock()


class _events_file_lock(object):
    """Cross-PROCESS exclusive lock for the events sidecar: surviving
    ranks on one machine share a scratch root, and the cap compaction's
    read-truncate-rewrite would otherwise discard a sibling's freshly
    appended line (the exact event the shuffle degrade depends on).
    flock on a sidecar lockfile — not the data file, whose inode
    ``os.replace`` swaps — released on process death.  Degrades to a
    no-op where flock is unsupported (same policy as resume.RunGuard)."""

    def __init__(self, path):
        self._path = path + ".lock"
        self._fd = None

    def __enter__(self):
        try:
            import fcntl

            os.makedirs(os.path.dirname(self._path), exist_ok=True)
            self._fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
            fcntl.flock(self._fd, fcntl.LOCK_EX)
        except OSError:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
        return self

    def __exit__(self, *exc):
        if self._fd is not None:
            try:
                import fcntl

                fcntl.flock(self._fd, fcntl.LOCK_UN)
            finally:
                os.close(self._fd)
                self._fd = None
        return False


def record_event(run_name, kind, **fields):
    """Append one fault event for ``run_name`` (O_APPEND, bounded,
    best-effort — this runs on paths that are already dying and must
    never mask the original failure).  Returns the path or None."""
    if not run_name:
        return None
    try:
        rec = {"kind": kind, "ts": round(time.time(), 3)}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=True, default=str)
        if "\n" in line:
            return None
        path = events_path(run_name)
        with _events_lock, _events_file_lock(path):
            _append_jsonl(path, [line])
            _compact_events(path)
        return path
    except Exception:
        log.warning("fault event append failed for %r", run_name,
                    exc_info=True)
        return None


def _compact_events(path):
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return
    if len(lines) <= EVENTS_CAP:
        return
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(lines[-EVENTS_CAP:])
    os.replace(tmp, path)


def load_events(run_name):
    """Every valid fault event for a run name, oldest -> newest."""
    if not run_name:
        return []
    return _load_jsonl(events_path(run_name),
                       keep=lambda rec: bool(rec.get("kind")))


def clear_events(run_name):
    try:
        os.unlink(events_path(run_name))
    except OSError:
        pass


def stages_with_exchange_timeouts(run_name):
    """Stage ids whose collective exchange timed out in a PREVIOUS run
    under this name — the plan layer degrades those stages to the host
    shuffle until the operator clears ``faults.jsonl`` (a hung gloo
    collective is catastrophic; host-until-told-otherwise is the safe
    direction)."""
    sids = set()
    for ev in load_events(run_name):
        if ev.get("kind") == "exchange_timeout" and isinstance(
                ev.get("stage"), int):
            sids.add(ev["stage"])
    return sids
