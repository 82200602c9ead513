"""Wall-time attribution of device work, and which run a keyed device
call is charged to.

Buckets, accumulated process-wide behind one lock (the JAX package's
``ops/devtime.py``, with the same meanings):

- ``device``:   kernel dispatch and result sites (the lowered sink's
                enqueue and drain, the handoff's table program, the keyed
                batch ops' hash/sort/fold calls, the device fold);
- ``transfer``: explicit host<->device lane movement (HBM tier puts,
                value-lane fetches);
- ``codec``:    the native C tokenizer (host, but worth separating from
                generic Python time);
- ``codec_wait``: WALL-CLOCK union of intervals during which EVERY live
                map slot was blocked on its codec: each slot's fold
                consumer waiting for the next block while that slot's
                producer thread was inside the native codec (the overlap
                executor, ``runner._overlap_stream``, via
                :func:`slot_stall`/:func:`slot_unstall`).  It is the codec
                time still on the critical path after overlapping; with
                the overlap executor off it stays 0.

Times are dispatch-site THREAD-seconds (``codec_wait`` excepted: it is a
wall-clock union and never exceeds elapsed wall).  On CUDA a kernel
launch returns before the card finishes, so the ``device`` bucket is the
host's time at the sites where it queues work and where it waits for
results, as on a TPU; no site synchronises to time itself, and a bucket
closes at the wait the code already has.  A profiler-grade kernel
timeline is ``settings.profile_dir`` (``torch.profiler``).

The keyed batch ops (:mod:`.hashing`, :mod:`.segment`) also charge each
device call to the run whose job made it: the runner binds its
:class:`~dampr_tpu_torch.storage.RunStore` to each job's thread
(:func:`charging`), and :func:`keyed` charges the call to it
(``RunStore.count_keyed``): its host seconds per op, its bytes into the
run's h2d/d2h counters.  A call made outside a run's job is charged to no
run.
"""

import contextlib
import threading
import time

from ..obs import profile as _profile
from ..obs import trace as _trace

_lock = threading.Lock()
_counters = {"device": 0.0, "transfer": 0.0, "codec": 0.0,
             "codec_wait": 0.0}
_active = {}  # (thread ident, kind) -> nesting depth inside track(kind)

# codec_wait state: live overlap slots against slots blocked on their own
# producer's codec.  The union interval is open exactly while every live
# slot is stalled (_all_since is its start).
_slots = 0
_stalled = 0
_all_since = None

_local = threading.local()


def _roll_union_locked():
    """Close or open the all-slots-stalled interval after a change."""
    global _all_since
    all_stalled = _slots > 0 and _stalled >= _slots
    if _all_since is None and all_stalled:
        _all_since = time.perf_counter()
    elif _all_since is not None and not all_stalled:
        _counters["codec_wait"] += time.perf_counter() - _all_since
        _all_since = None


def slot_enter():
    """A map slot's overlapped fold consumer came alive."""
    global _slots
    with _lock:
        _slots += 1
        _roll_union_locked()


def slot_exit():
    global _slots
    with _lock:
        _slots -= 1
        _roll_union_locked()


def slot_stall():
    """This slot's consumer is blocked while its producer is in the
    native codec."""
    global _stalled
    with _lock:
        _stalled += 1
        _roll_union_locked()


def slot_unstall():
    global _stalled
    with _lock:
        _stalled -= 1
        _roll_union_locked()


def live_slots():
    """Overlap fold consumers alive now (an unlocked read: a sampled
    gauge tolerates a torn value)."""
    return _slots


def stalled_slots():
    """Slots blocked on their producer's codec now."""
    return _stalled


def _enter(kind):
    """Open a ``kind`` region on this thread.  Only codec regions feed
    :func:`active_in`: the others skip the lock and the bookkeeping."""
    if kind == "codec":
        key = (threading.get_ident(), kind)
        with _lock:
            _active[key] = _active.get(key, 0) + 1


def _leave(kind, seconds):
    """Close the region :func:`_enter` opened, adding its seconds."""
    with _lock:
        if kind == "codec":
            key = (threading.get_ident(), kind)
            depth = _active.get(key, 1) - 1
            if depth:
                _active[key] = depth
            else:
                _active.pop(key, None)
        _counters[kind] += seconds


@contextlib.contextmanager
def track(kind):
    _enter(kind)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _leave(kind, time.perf_counter() - t0)


class Timed(object):
    """One timing site: the wall clock read once at each end feeds the
    ``kind`` bucket (as :func:`track`; None for none) and, while tracing,
    one span ``cat:name`` on this thread (no span when ``cat`` is None).
    While the tracer or the per-operator profiler is on it reads this
    thread's CPU clock too, inside the wall reads, so ``cpu`` never
    exceeds ``seconds``.  After the block the caller feeds its own
    counters from ``seconds`` and ``cpu`` (None when not read); ``args``
    may gain entries inside the block."""

    __slots__ = ("kind", "cat", "name", "args", "seconds", "cpu", "_t0",
                 "_c0", "_tracer")

    def __init__(self, kind, cat=None, name=None, **args):
        self.kind = kind
        self.cat = cat
        self.name = name
        self.args = args
        self.seconds = 0.0
        self.cpu = None

    def __enter__(self):
        self._tracer = _trace.active()
        if self.kind is not None:
            _enter(self.kind)
        self._t0 = time.perf_counter()
        self._c0 = (time.thread_time() if self._tracer is not None
                    or _profile.enabled() else None)
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._c0 is not None:
            self.cpu = time.thread_time() - self._c0
        self.seconds = time.perf_counter() - self._t0
        if self.kind is not None:
            _leave(self.kind, self.seconds)
        if self._tracer is not None and self.cat is not None:
            self._tracer.interval(self.cat, self.name, self._t0,
                                  self.seconds, self.cpu, self.args)
        return False


def active_in(thread_ident, kind):
    """Is the given thread inside ``track(kind)`` now?  Lets a waiter
    charge its blocked time to the producer it waits on."""
    with _lock:
        return _active.get((thread_ident, kind), 0) > 0


def add(kind, seconds):
    with _lock:
        _counters[kind] += seconds


def union_seconds(intervals):
    """Total length of the union of ``(t0, t1)`` intervals: concurrent
    lanes doing the same kind of work count the covered wall once
    (:mod:`dampr_tpu_torch.obs.critpath`)."""
    total = 0.0
    end = None
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


def snapshot():
    with _lock:
        out = dict(_counters)
        if _all_since is not None:  # fold in the open stall interval
            out["codec_wait"] += time.perf_counter() - _all_since
        return out


def epoch():
    """Run-scoped accounting without :func:`reset`: capture the counters
    now and difference them later with :func:`delta`; concurrent runs each
    hold their own epoch."""
    return snapshot()


def delta(since):
    """Per-bucket seconds since an :func:`epoch` snapshot, clamped at 0
    (an interleaved :func:`reset` gives a short read, never a negative
    one)."""
    now = snapshot()
    return {k: max(0.0, now[k] - since.get(k, 0.0)) for k in now}


def reset():
    global _all_since
    with _lock:
        for k in _counters:
            _counters[k] = 0.0
        if _all_since is not None:  # an open interval restarts at zero
            _all_since = time.perf_counter()


@contextlib.contextmanager
def charging(store):
    """Charge the keyed device calls this thread makes to ``store``."""
    prev = getattr(_local, "store", None)
    _local.store = store
    try:
        yield
    finally:
        _local.store = prev


def keyed(name, seconds, h2d, d2h, cpu=None):
    """One device call of the keyed op ``name``: its seconds go into the
    ``device`` bucket, and its seconds (``cpu``, its thread CPU, where
    read) and bytes to the run charging this thread."""
    add("device", seconds)
    store = getattr(_local, "store", None)
    if store is not None:
        store.count_keyed(name, seconds, h2d, d2h, cpu=cpu)


def keyed_call(name):
    """The timing site of one keyed device call: a ``device:keyed-<name>``
    span; pass its reading to :func:`keyed`."""
    return Timed(None, "device", "keyed-" + name)
