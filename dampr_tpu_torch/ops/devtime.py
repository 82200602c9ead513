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


@contextlib.contextmanager
def track(kind):
    t0 = time.perf_counter()
    if kind != "codec":
        # only codec regions feed active_in(): the others skip the entry
        # lock and the _active bookkeeping
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with _lock:
                _counters[kind] += dt
        return
    key = (threading.get_ident(), kind)
    with _lock:
        _active[key] = _active.get(key, 0) + 1
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            depth = _active.get(key, 1) - 1
            if depth:
                _active[key] = depth
            else:
                _active.pop(key, None)
            _counters[kind] += dt


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


def keyed(name, seconds, h2d, d2h):
    """One device call of the keyed op ``name``: its seconds go into the
    ``device`` bucket, and its seconds and bytes to the run charging this
    thread."""
    add("device", seconds)
    store = getattr(_local, "store", None)
    if store is not None:
        store.count_keyed(name, seconds, h2d, d2h)
