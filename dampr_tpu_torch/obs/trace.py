"""Low-overhead run-scoped span recorder.

Design constraints, in order:

1. **Near-zero cost off.**  With no active tracer, ``span()`` /
   ``complete()`` / ``instant()`` are one module-global load + ``None``
   check; ``span()`` returns a shared no-op context manager (no
   allocation).  The engine's hot loops (per-block codec/fold, per-window
   merges) are instrumented unconditionally and rely on this.
2. **Thread-natural lanes.**  The engine's concurrency units ARE threads:
   map jobs run on pool workers (slots), each overlapped codec runs on its
   own named producer thread, reduce jobs on pool workers, merge
   generations on the stage walker.  Events therefore record the emitting
   thread's ident as their lane (Chrome ``tid``) by default, and the
   tracer remembers each lane's thread name once so the export can emit
   ``thread_name`` metadata — Perfetto then shows one track per slot.  An
   explicit ``lane="..."`` names a synthetic lane instead (used where one
   thread multiplexes logical lanes, e.g. merge generations).
3. **Append-only, lock-light.**  Events append to a plain list (atomic
   under the GIL); only lane-name interning takes a tiny setdefault.

Events are stored as compact tuples and converted to Chrome trace-event
dicts at export time (:mod:`.export`).  Timestamps are
``time.perf_counter()`` seconds relative to the tracer's epoch.

Scope: the active tracer is process-global (runs own it run-scoped via
``start``/``stop``).  Two *concurrent* traced runs in one process would
interleave spans into whichever tracer started last; the runner documents
this and run-level metrics stay exact regardless (they come from
run-scoped counters, not spans).
"""

import threading
import time


class _NoopSpan(object):
    """Shared do-nothing context manager returned when tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NOOP = _NoopSpan()

#: The active tracer (innermost, when runs nest) or None.  Read unlocked on
#: the hot path; start/stop mutate under _lock.
_active = None
_stack = []
_lock = threading.Lock()


class _Span(object):
    """A live ``with``-span: records one complete ("X") event on exit."""

    __slots__ = ("_tracer", "_cat", "_name", "_lane", "_args", "_t0")

    def __init__(self, tracer, cat, name, lane, args):
        self._tracer = tracer
        self._cat = cat
        self._name = name
        self._lane = lane
        self._args = args
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._tracer._record(self._cat, self._name, self._t0,
                             time.perf_counter() - self._t0,
                             self._lane, self._args)
        return False


class Tracer(object):
    """One run's span collection.

    ``events`` holds ``(cat, name, t0, dur, lane, args)`` tuples —
    ``t0``/``dur`` in perf_counter seconds relative to ``epoch``; ``dur``
    is None for instant events; ``lane`` is a thread ident (int) or an
    explicit lane string.
    """

    def __init__(self, run_name):
        self.run = run_name
        self.epoch = time.perf_counter()
        self.wall_start = time.time()
        self.events = []
        self.lane_names = {}   # lane id -> display name
        #: Optional flight recorder (obs.flightrec): every recorded span
        #: is mirrored into its bounded ring so a killed run's crashdump
        #: carries the most recent timeline tail.  None costs one
        #: attribute load per recorded event (never on the disabled
        #: path, which returns before _record).
        self.recorder = None

    # -- recording ---------------------------------------------------------
    def _record(self, cat, name, t0, dur, lane, args):
        if lane is None:
            lane = threading.get_ident()
            if lane not in self.lane_names:
                self.lane_names[lane] = threading.current_thread().name
        elif lane not in self.lane_names:
            self.lane_names[lane] = str(lane)
        self.events.append((cat, name, t0 - self.epoch, dur, lane, args))
        rec = self.recorder
        if rec is not None:
            rec.record_span(cat, name, t0, dur, lane,
                            self.lane_names.get(lane), args)

    def span(self, cat, name, lane=None, **args):
        return _Span(self, cat, name, lane, args or None)

    def complete(self, cat, name, t0, lane=None, **args):
        """Record an already-measured interval (retrofit sites that had
        their own ``t0 = now()``)."""
        self._record(cat, name, t0, time.perf_counter() - t0, lane,
                     args or None)

    def instant(self, cat, name, lane=None, **args):
        self._record(cat, name, time.perf_counter(), None, lane,
                     args or None)

    # -- summary -----------------------------------------------------------
    def span_summary(self):
        """{cat: {"count": n, "seconds": s}} for the stats.json summary.
        Derived from the event list at summary time (one O(n) pass on the
        run's single finalizing thread) — concurrent recorders only ever
        touch the append-atomic event list, so counts here always agree
        with the events in trace.json."""
        agg = {}
        for cat, _name, _t0, dur, _lane, _args in self.events:
            a = agg.setdefault(cat, [0, 0.0])
            a[0] += 1
            if dur is not None:
                a[1] += dur
        return {cat: {"count": a[0], "seconds": round(a[1], 6)}
                for cat, a in sorted(agg.items())}


# -- module-level API (the instrumentation surface) -------------------------

def start(tracer):
    """Make ``tracer`` the active recorder (run-scoped: pair with stop)."""
    global _active
    with _lock:
        _stack.append(tracer)
        _active = tracer


def stop(tracer):
    global _active
    with _lock:
        if tracer in _stack:
            _stack.remove(tracer)
        _active = _stack[-1] if _stack else None


def enabled():
    return _active is not None


def now():
    """perf_counter timestamp for a later ``complete()`` — 0.0 when off so
    disabled call sites skip the clock read entirely."""
    return time.perf_counter() if _active is not None else 0.0


def span(cat, name, lane=None, **args):
    t = _active
    if t is None:
        return _NOOP
    return _Span(t, cat, name, lane, args or None)


def complete(cat, name, t0, lane=None, **args):
    # t0 == 0.0 is the "tracing was off at now()" sentinel: a tracer that
    # started between the paired now()/complete() must not record a span
    # spanning the whole process uptime.
    t = _active
    if t is not None and t0:
        t.complete(cat, name, t0, lane=lane, **args)


def instant(cat, name, lane=None, **args):
    t = _active
    if t is not None:
        t.instant(cat, name, lane=lane, **args)


def timed_iter(items, cat, name, lane=None):
    """Wrap an iterator so each ``next()`` is recorded as one span (the
    overlapped codec producer's per-window accounting).  Returns ``items``
    unchanged when tracing is off — zero per-item overhead."""
    t = _active
    if t is None:
        return items

    def gen():
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            t.complete(cat, name, t0, lane=lane)
            yield item

    return gen()
