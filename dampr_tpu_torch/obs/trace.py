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

4. **Work and waiting apart.**  While a tracer is active every span also
   reads ``time.thread_time()`` at its start and end: its ``cpu`` seconds
   are the part of its wall interval its thread spent on a core; the rest
   it waited (for the interpreter lock, another lock, a core, the card).
   :meth:`Tracer.span_summary` adds each category's self time, the span
   less its children on the same thread, in wall and CPU seconds.

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

    __slots__ = ("_tracer", "_cat", "_name", "_lane", "_args", "_t0", "_c0")

    def __init__(self, tracer, cat, name, lane, args):
        self._tracer = tracer
        self._cat = cat
        self._name = name
        self._lane = lane
        self._args = args
        self._t0 = self._c0 = 0.0

    def __enter__(self):
        # wall outside CPU at both ends: a span's cpu never exceeds its dur
        self._t0 = time.perf_counter()
        self._c0 = time.thread_time()
        return self

    def __exit__(self, exc_type, exc, tb):
        cpu = time.thread_time() - self._c0
        self._tracer._record(self._cat, self._name, self._t0,
                             time.perf_counter() - self._t0,
                             self._lane, self._args, cpu)
        return False


class Stamp(float):
    """A :func:`now` reading while tracing: ``perf_counter`` seconds (it
    is the float) that also carry the reading thread's CPU clock, so the
    paired :func:`complete` can record the span's ``cpu``."""

    __slots__ = ("cpu", "thread")


def _stamp():
    t = Stamp(time.perf_counter())
    t.cpu = time.thread_time()
    t.thread = threading.get_ident()
    return t


def _wall_anchor(tries=3):
    """``(perf_counter, time.time(), width)``: the narrowest of ``tries``
    wall-clock reads bracketed by ``perf_counter`` reads, the perf value
    at the bracket's middle.  The width bounds the error of mapping a
    span onto the wall clock (and so onto a profiler's timeline)."""
    best = None
    for _ in range(tries):
        a = time.perf_counter()
        w = time.time()
        b = time.perf_counter()
        if best is None or b - a < best[2]:
            best = ((a + b) / 2.0, w, b - a)
    return best


class Tracer(object):
    """One run's span collection.

    ``events`` holds ``(cat, name, t0, dur, lane, args, cpu, thread)``
    tuples — ``t0``/``dur`` in perf_counter seconds relative to ``epoch``;
    ``dur`` is None for instant events; ``lane`` is a thread ident (int)
    or an explicit lane string; ``cpu`` the recording thread's CPU seconds
    inside the span (None for instants, and for a :func:`complete` whose
    start was not a :class:`Stamp` of the same thread); ``thread`` the
    recording thread's ident, which nests spans for self time whatever
    lane they name.  Readers take the first six fields where they accept
    tuples from elsewhere too.
    """

    def __init__(self, run_name):
        self.run = run_name
        self.epoch, self.wall_start, width = _wall_anchor()
        #: the anchor's bracket in microseconds: how far a span's wall
        #: time (``wall_start`` + its offset) may be off
        self.wall_start_err_us = width * 1e6
        self.events = []
        self.lane_names = {}   # lane id -> display name
        #: lane id -> ``(OS thread id, thread ident)`` of the thread that
        #: owns it (first recorded on it): ``threading.get_native_id``,
        #: which a profiler with CPU activity stamps on its host-side
        #: events, and ``threading.get_ident`` (the pthread id), whose low
        #: 32 bits a CUDA-only profiler's runtime events carry
        self.lane_threads = {}
        #: Optional flight recorder (obs.flightrec): every recorded span
        #: is mirrored into its bounded ring so a killed run's crashdump
        #: carries the most recent timeline tail.  None costs one
        #: attribute load per recorded event (never on the disabled
        #: path, which returns before _record).
        self.recorder = None

    # -- recording ---------------------------------------------------------
    def _record(self, cat, name, t0, dur, lane, args, cpu=None):
        thread = threading.get_ident()
        if lane is None:
            lane = thread
        if lane not in self.lane_names:
            self.lane_names[lane] = (threading.current_thread().name
                                     if lane == thread else str(lane))
            self.lane_threads[lane] = (threading.get_native_id(), thread)
        self.events.append((cat, name, t0 - self.epoch, dur, lane, args,
                            cpu, thread))
        rec = self.recorder
        if rec is not None:
            rec.record_span(cat, name, t0, dur, lane,
                            self.lane_names.get(lane), args)

    def span(self, cat, name, lane=None, **args):
        return _Span(self, cat, name, lane, args or None)

    def complete(self, cat, name, t0, lane=None, **args):
        """Record an already-measured interval (retrofit sites that had
        their own ``t0 = now()``); its ``cpu`` when ``t0`` is this
        thread's :class:`Stamp`."""
        cpu = None
        if getattr(t0, "thread", None) == threading.get_ident():
            cpu = time.thread_time() - t0.cpu
        self._record(cat, name, t0, time.perf_counter() - t0, lane,
                     args or None, cpu)

    def interval(self, cat, name, t0, dur, cpu, args=None):
        """Record an interval a timing site measured itself (its one
        clock reading feeds its own counters too), on this thread's
        lane."""
        self._record(cat, name, t0, dur, None, args or None, cpu)

    def instant(self, cat, name, lane=None, **args):
        self._record(cat, name, time.perf_counter(), None, lane,
                     args or None)

    # -- summary -----------------------------------------------------------
    def span_summary(self):
        """{cat: {"count", "seconds", "cpu_seconds", "self_seconds",
        "self_cpu_seconds"}} for the stats.json summary.

        A span's self time is its interval less the part that child spans
        recorded by the same thread cover, and its self CPU its ``cpu``
        less theirs: nesting follows the recording thread, not the display
        lane, since several threads may feed one explicit lane.  A span
        with no ``cpu`` counts none.  Derived from the event list at
        summary time (on the run's single finalizing thread): concurrent
        recorders only ever touch the append-atomic event list, so counts
        here always agree with the events in trace.json."""
        agg = {}
        by_thread = {}
        for ev in self.events:
            a = agg.setdefault(ev[0], [0, 0.0, 0.0, 0.0, 0.0])
            a[0] += 1
            if ev[3] is None:
                continue
            a[1] += ev[3]
            a[2] += ev[6] or 0.0
            by_thread.setdefault(ev[7], []).append(ev)

        def close(entry):
            _end, covered, child_cpu, ev = entry
            a = agg[ev[0]]
            a[3] += max(0.0, ev[3] - covered)
            a[4] += max(0.0, (ev[6] or 0.0) - child_cpu)

        for spans in by_thread.values():
            spans.sort(key=lambda e: (e[2], -e[3]))
            stack = []  # [end, wall its children cover, their cpu, event]
            for ev in spans:
                t0, end = ev[2], ev[2] + ev[3]
                while stack and stack[-1][0] <= t0:
                    close(stack.pop())
                if stack:
                    parent = stack[-1]
                    parent[1] += min(end, parent[0]) - t0
                    parent[2] += ev[6] or 0.0
                stack.append([end, 0.0, 0.0, ev])
            while stack:
                close(stack.pop())
        return {cat: {"count": a[0], "seconds": round(a[1], 6),
                      "cpu_seconds": round(a[2], 6),
                      "self_seconds": round(a[3], 6),
                      "self_cpu_seconds": round(a[4], 6)}
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


def active():
    """The active tracer or None (a timing site that records its own
    reading through :meth:`Tracer.interval`)."""
    return _active


def now():
    """perf_counter timestamp for a later ``complete()`` — a
    :class:`Stamp` carrying this thread's CPU clock too; 0.0 when off so
    disabled call sites skip the clock reads entirely."""
    return _stamp() if _active is not None else 0.0


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


def timed_iter(items, cat, name, lane=None, **args):
    """Wrap an iterator so each ``next()`` is recorded as one span (the
    overlapped codec producer's per-window accounting).  Returns ``items``
    unchanged when tracing is off — zero per-item overhead."""
    t = _active
    if t is None:
        return items
    args = args or None

    def gen():
        it = iter(items)
        while True:
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                item = next(it)
            except StopIteration:
                return
            cpu = time.thread_time() - c0
            t._record(cat, name, t0, time.perf_counter() - t0, lane, args,
                      cpu)
            yield item

    return gen()
