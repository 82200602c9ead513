"""Per-operator profiler: attribute fused-stage time to the user's ops.

Plan fusion (:mod:`dampr_tpu_torch.plan.passes`) deliberately collapses
chains of user operators into single executed stages, and device
lowering (:mod:`dampr_tpu_torch.ops.lower`) runs a whole map->fold shape
as one device program — great for throughput, opaque for diagnosis: the trace
can say *stage 2 took 40 s* but not which of the four fused ops the time
went to.  This module is the attribution layer under ``settings.profile``
(env ``DAMPR_TPU_TORCH_PROFILE=1``):

- **fused host stages**: every composed ``apply_batch`` step of the
  batched-UDF path is timed per call (one clock pair per op per BATCH —
  never per record), codec windows are timed per window and attributed
  to the scanner op that produced them, and map-side partial/final folds
  to the stage's combiner; each op cell carries its thread CPU seconds
  beside its wall (``cpu_seconds``);
- **device stages**: the device sink's sub-phases, host seconds at
  each — ``build`` (padded-matrix construction), ``h2d`` (the batch's
  copies and the kernels' enqueue), ``compute`` (the host blocked on
  the card at the drain), ``d2h`` (result fetch and decode) — accumulate separately, decomposing the aggregate
  ``device`` span the trace records;
- **jobs**: every pool job's wall time lands on its stage, so the
  summary can report *coverage* — the fraction of job thread-seconds the
  per-op attribution explains (the acceptance bar: >= 0.9 on fused
  scanner stages).

Design contract, identical to :mod:`.trace` / :mod:`.metrics`:

1. **Near-zero cost off.**  With no active profiler every module-level
   call site is one module-global load + ``None`` check; hot loops hoist
   even that to one check per job.  No thread is ever started (the
   profiler is passive — it only accumulates under a small lock at
   batch/window/job granularity).
2. **Run-scoped, process-global active instance** via ``start``/``stop``
   (the runner owns the lifecycle); concurrent profiled runs would
   interleave into the innermost profiler, same caveat as the tracer.

The summary ships as ``stats()["profile"]``.
"""

import threading
import time

#: The active profiler or None.  Read unlocked on the hot path;
#: start/stop mutate under _lock.
_active = None
_stack = []
_lock = threading.Lock()


def op_label(op, index=None):
    """Stable display label for one operator of a fused chain:
    ``TypeName(fn_name)`` where the wrapped function has a useful name.
    Index-prefixed labels (``"1:ValueMap(tf)"``) keep duplicate op types
    within one chain distinct."""
    fn = None
    for attr in ("mapper", "f", "key_f", "reducer", "sinker", "op"):
        fn = getattr(op, attr, None)
        if fn is not None:
            break
    label = type(op).__name__
    name = getattr(fn, "__name__", None)
    if name and name != "<lambda>":
        label = "{}({})".format(label, name)
    if index is None:
        return label
    return "{}:{}".format(index, label)


def chain_labels(ops):
    """Index-prefixed labels for an ordered operator chain."""
    return [op_label(op, i) for i, op in enumerate(ops)]


class Profiler(object):
    """One run's per-operator attribution.

    Per executed stage (keyed by sid): an ``ops`` table mapping operator
    label -> ``[seconds, records, calls, cpu seconds]`` (the thread CPU
    inside the op's seconds, None where no site passed it), a ``device``
    table mapping
    sub-phase -> ``[seconds, bytes, calls]``, and job accounting
    (``jobs``, ``job_seconds`` thread-seconds).  All adds take one small
    lock; granularity is per batch / window / job, so contention is
    negligible next to the work being measured."""

    def __init__(self, run_name):
        self.run = run_name
        self._mu = threading.Lock()
        self._stages = {}
        #: The stage currently executing.  The runner's stage walk is
        #: sequential, so a single run-global current sid is exact; the
        #: stage's concurrent jobs all belong to it.
        self.sid = None

    # -- stage lifecycle (runner's sequential walk) -------------------------
    def begin_stage(self, sid, kind, provenance=None):
        with self._mu:
            self._stages[sid] = {
                "stage": sid, "kind": kind,
                "provenance": list(provenance) if provenance else None,
                "ops": {}, "device": {},
                "jobs": 0, "job_seconds": 0.0,
            }
            self.sid = sid

    def _rec(self, sid):
        if sid is None:
            sid = self.sid
        rec = self._stages.get(sid)
        if rec is None:
            # Attribution from outside a began stage (direct runner use,
            # tests): accumulate under a synthetic stage record instead
            # of dropping the sample.
            rec = self._stages[sid] = {
                "stage": sid, "kind": "?", "provenance": None,
                "ops": {}, "device": {}, "jobs": 0, "job_seconds": 0.0,
            }
        return rec

    # -- accumulation (hot sites; per batch/window/job, never per record) ---
    def op_add(self, label, seconds, records=0, calls=1, sid=None,
               cpu=None):
        with self._mu:
            ops = self._rec(sid)["ops"]
            cell = ops.get(label)
            if cell is None:
                ops[label] = [seconds, records, calls, cpu]
            else:
                cell[0] += seconds
                cell[1] += records
                cell[2] += calls
                if cpu is not None:
                    cell[3] = (cell[3] or 0.0) + cpu

    def op_since(self, label, since, records=0, calls=1, sid=None):
        """:meth:`op_add` for an op timed from ``since``, a :func:`mark`
        taken before it: its wall and its thread CPU."""
        cpu = time.thread_time() - since[1]
        self.op_add(label, time.perf_counter() - since[0], records, calls,
                    sid, cpu)

    def device_add(self, phase, seconds, nbytes=0, sid=None):
        with self._mu:
            dev = self._rec(sid)["device"]
            cell = dev.get(phase)
            if cell is None:
                dev[phase] = [seconds, nbytes, 1]
            else:
                cell[0] += seconds
                cell[1] += nbytes
                cell[2] += 1

    def job_add(self, seconds, sid=None):
        with self._mu:
            rec = self._rec(sid)
            rec["jobs"] += 1
            rec["job_seconds"] += seconds

    def timed_iter(self, items, label, sid=None, records_of=None):
        """Wrap an iterator so each ``next()`` — a codec window's
        decompress/tokenize/parse — is attributed to ``label``.  Records
        one op_add per WINDOW; ``records_of(item)`` overrides the
        default ``len(item)`` record count."""
        if sid is None:
            sid = self.sid

        def count(item):
            if records_of is not None:
                try:
                    return records_of(item)
                except Exception:
                    return 0
            if item is not None and hasattr(item, "__len__"):
                return len(item)
            return 0

        def gen():
            it = iter(items)
            while True:
                since = mark()
                try:
                    item = next(it)
                except StopIteration:
                    # the iterator's teardown (a last window's flush, a
                    # producer thread's join) is the op's too
                    self.op_since(label, since, records=0, calls=0,
                                  sid=sid)
                    return
                self.op_since(label, since, records=count(item), sid=sid)
                yield item

        return gen()

    # -- summary ------------------------------------------------------------
    def summary(self, stage_seconds=None):
        """The ``profile`` section of stats.json.  ``stage_seconds``
        (optional {sid: wall seconds} from StageStats) adds per-stage
        wall so consumers can relate coverage to elapsed time."""
        stage_seconds = stage_seconds or {}
        stages = []
        with self._mu:
            recs = sorted(self._stages.items())
        for sid, rec in recs:
            ops = []
            for label, c in sorted(rec["ops"].items(),
                                   key=lambda kv: -kv[1][0]):
                op = {"op": label, "seconds": round(c[0], 6),
                      "records": c[1], "calls": c[2]}
                if c[3] is not None:
                    op["cpu_seconds"] = round(c[3], 6)
                ops.append(op)
            device = {phase: {"seconds": round(c[0], 6), "bytes": c[1],
                              "calls": c[2]}
                      for phase, c in sorted(rec["device"].items())}
            attributed = (sum(o["seconds"] for o in ops)
                          + sum(d["seconds"] for d in device.values()))
            job_s = rec["job_seconds"]
            entry = {
                "stage": sid, "kind": rec["kind"],
                "ops": ops, "device": device,
                "jobs": rec["jobs"],
                "job_seconds": round(job_s, 6),
                "attributed_seconds": round(attributed, 6),
                # How much of the stage's job thread-seconds the per-op
                # attribution explains (capped: attribution sites can
                # slightly overlap job timing at the edges).
                "coverage": (round(min(1.0, attributed / job_s), 4)
                             if job_s > 1e-9 else None),
            }
            if rec["provenance"]:
                entry["provenance"] = rec["provenance"]
            if sid in stage_seconds:
                entry["seconds"] = round(stage_seconds[sid], 4)
            stages.append(entry)
        return {"enabled": True, "stages": stages}


# -- module-level API (the instrumentation surface) -------------------------

def start(profiler):
    """Make ``profiler`` the active instance (run-scoped: pair with
    stop)."""
    global _active
    with _lock:
        _stack.append(profiler)
        _active = profiler


def stop(profiler):
    global _active
    with _lock:
        if profiler in _stack:
            _stack.remove(profiler)
        _active = _stack[-1] if _stack else None


def active():
    """The active profiler or None — hot sites hoist this to one load +
    None-check per job."""
    return _active


def enabled():
    return _active is not None


def mark():
    """``(perf_counter, thread_time)`` now, for :meth:`Profiler.op_since`
    (wall outside CPU: an op's CPU never exceeds its seconds)."""
    t = time.perf_counter()
    return t, time.thread_time()


def device_add(phase, seconds, nbytes=0):
    p = _active
    if p is not None:
        p.device_add(phase, seconds, nbytes)
