"""The scheduler: a sequential stage walk, parallel jobs within a stage.

Reduced port of ``dampr_tpu/runner.py``'s ``MTRunner``: ``run_map``,
``run_reduce`` and ``run_sink``, each stage's jobs on a thread pool, each
job with its own clone of the stage's operator (:func:`_clone_op`).

A map stage runs one job per chunk of its first input; its other inputs
(the broadcast side of a cross) reach every job whole, as chunk lists.  A
reduce stage runs one job per partition id, empty ones included, over one
key-sorted :class:`~.base.GroupedView` per input: folds, user reducers and
the sort-merge joins of co-partitioned inputs.

``run_map`` has the branches of the reference's map job:

- a **device-lowered** scanner stage (``exec_target == "device"``, set by
  :mod:`.plan.lower`) drives the chunk's line-aligned windows through
  :class:`.ops.lower.DeviceTokenFoldSink` — the FNV and segmented-fold
  kernels on ``settings.device``;
- a **certified numeric chain** (``exec_target == "device"`` on a chain
  :mod:`.analyze.torchtrace` certifies) takes the batched record path
  with its lane program: whole batches evaluated vectorized, dispatched
  to ``settings.device`` and checked against the host's result;
- everything else runs on host: ``map_blocks`` scanners, identity block
  pass-through, the **batched record path** (a chain of typed record ops,
  ``base.record_op_chain``, run a batch at a time through each op's
  ``apply_batch``), or the per-record ``mapper.map`` path into blocks.

A device-lowered or ``map_blocks`` scan runs under the **overlap
executor** (:func:`_overlap_stream`): a producer thread runs the codec
(inflate, tokenize, the device sink's copies and kernels) up to
:data:`OVERLAP_WINDOWS` blocks ahead of the job thread's fold, every
block in flight charged to the budget.  Map stages that read the same
tap run as one **scan-shared** group (:meth:`MTRunner.run_map_group`):
one window pass per chunk feeds every member's sink where the chunk
streams its bytes, else the members share one read of it.  A small
materialized input (:data:`SMALL_STAGE_BYTES`) to a pure record
map, a broadcast join or a sink runs as **one job**, and a small
associative fold reduces every partition in one pass
(:meth:`MTRunner._tiny_assoc_reduce`).

Either way the job's blocks go through the map-side combine
(``segment.fold_block``) when the stage carries one, then hash
partitioning into the store; a ``cached()`` stage registers them pinned.
A stage whose output no reduce consumes runs in **sorted-run mode**:
each job registers its chunk as one key-sorted run of numeric keys (hash
fan-out when its keys are not uniformly numeric or hold NaN), and the
final read merges the runs, past ``settings.merge_fanin`` after streamed
merge generations
(:meth:`MTRunner._plan_sorted_merge`).

The **out-of-core** reduce paths take a partition over
``settings.streaming_reduce_threshold`` (the budget by default): an
associative fold folds window by window into an accumulator of distinct
keys (:func:`_streaming_assoc_fold` inside ``run_reduce``), falling back
to the record stream when that outgrows the threshold; an
order-insensitive reducer reads a :class:`~.base.StreamingGroupedView`
(groups in hash order); a keyed join merges both sides by hash
(:func:`~.base.streaming_merge_join`).  Spills go through the store's
writer pool, drained at every stage boundary and aborted on a failed run.

``stats()`` (the emitter's ``stats()``) is the JAX package's run summary
(``dampr-tpu-stats/1``, :mod:`.obs`), built by :meth:`MTRunner.
_finalize_obs` on success and failure: the plan (rules fired, stages
before and after fusion, per-stage targets), per-stage records and bytes
in and out, spill and merge counts, the devtime buckets, the ``io``
section (spill write and read MB/s, ``io_wait``, the writer pool's peaks,
the overlap executor's peak bytes in flight), the streamed reduces, the
scan-shared groups (``scan_sharing``), the tiny folds, and, under
``device``, ``device_stages``, ``device_fraction`` (devtime's device
bucket over wall), the sink's host phases, the h2d/d2h bytes, each
kernel's launches, the keyed batch ops' device calls (``keyed``) and the
HBM tier's and the handoff's counters during the run; every job charges
its keyed calls to the run's store (:mod:`.ops.devtime`), so their copies
count in the h2d/d2h bytes.  ``MTRunner.run`` owns the observability
lifecycle (``_start_obs``/``_stop_obs``): the tracer, the metrics plane,
the structured log, the flight recorder (flushed on failure, after the
store's writes are aborted and its device lanes released), the
per-operator profiler, and the ``settings.profile_dir`` hatch
(``torch.profiler``).

The **device handoff** (:mod:`.ops.handoff`): when the plan marks a
lowered map's edge into a device fold ``handoff="device"``, each job keeps
its counts in a device vocabulary and registers them as device-resident
refs at its end; map outputs a device fold reads enter the store's HBM
tier; and a reduce whose input holds device refs folds on the device
(:meth:`MTRunner._mesh_reduce`, on one device), so the counts stay on the
card from the map's batches to the fold's final fetch.  A failed run
releases every device ref.

The plan sizes a named run from its history (:mod:`.plan.cost`): the run's
``n_partitions`` unless the caller passed one, a map stage's
``batch_size`` and a reduce's ``n_reducers`` options.  A **streamed
edge** (:mod:`.plan.pipeline`, ``runner._pipeline_edges``) dissolves a
barrier: a map feeding an associative sum/min/max fold publishes each
finished job's blocks to a folder thread that pre-folds them while the
map runs (:class:`_StreamFolder`), and an unfused map -> map chain runs
the consumer's jobs per finished producer block (:meth:`MTRunner.
_run_chain`).  Every finalized run appends one record to its name's
run history (:mod:`.obs.history`); a failed one appends nothing.

**Faults and resume** (:mod:`.faults`, :mod:`.resume`): every job runs
inside ``store.attempt()`` under ``settings.job_retries``, so a failed
attempt's refs (device lanes and HBM charge included) are dropped before
a classified retry; the batched record path bisects deterministic
failures into the quarantine sink under ``settings.max_quarantined``;
the fault sites ``fold``, ``udf``, ``overlap_produce`` and
``stream_publish`` sit here.  A run with ``resume=True`` persists each
stage (a manifest with a chained fingerprint) and restores the valid
prefix on a rerun, skipping every stage no restored output needs; a
run of any kind holds its scratch root's liveness lock and sweeps blocks
no manifest references.  An identity checkpoint over a materialized
partition set aliases it where :meth:`MTRunner._alias_provenance_ok`
allows.  SIGTERM during a run raises ``SystemExit(143)``, the failed
run's path.

Mesh execution across cards, mitigation and the cross-run cache are
later slices.
"""

import collections
import copy
import itertools
import logging
import os
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from . import base, plan, settings, storage
from . import faults as _faults
from .blocks import Block, BlockBuilder, merge_sorted_streams, pylist
from .dataset import (BlockDataset, CatDataset, Chunker, Dataset, OrderKey,
                      SinkDataset, StreamDataset, merged_read)
from .graph import GInput, GMap, GReduce, GSink
from .inputs import close_readahead
from .ops import devtime
from .ops import fnv as _fnv
from .ops import handoff as _handoff
from .ops import lower as ops_lower
from .ops import segfold as _segfold
from .ops import segment
from .obs import log as _obslog
from .obs import metrics as _metrics
from .obs import profile as _profile
from .obs import trace as _trace

log = logging.getLogger("dampr_tpu_torch.runner")

#: Partial fold blocks (map-side combine, the streaming reduce-side fold)
#: merge once this many accumulate.
_PARTIAL_FANIN = 8

#: A stage-output partition holding more refs than this merges them in
#: rounds (:meth:`MTRunner._compact_partitions`).
MAX_FILES_PER_STAGE = 50

#: Stages whose materialized input is at most this many bytes collapse to
#: one job: a pure record map or a sink runs once over the concatenated
#: refs, and an associative fold reduces every partition in one pass,
#: then re-splits by the same hash % P (its output keeps hash order
#: within a partition).  0 turns the collapse off.
SMALL_STAGE_BYTES = 4 * 1024 * 1024

#: Codec -> fold overlap depth: a map job's codec (window scan, inflate,
#: tokenize, the lowered device sink) runs on a producer thread up to
#: this many blocks ahead of the fold/register loop, every block in
#: flight charged to the memory budget (``RunStore.reserve_overlap``).
#: 0 runs both on the job thread.
OVERLAP_WINDOWS = 2

#: Seconds the consumer waits for a stopped overlap producer to exit
#: before the run fails.
_PRODUCER_JOIN_SECONDS = 10.0

#: Lanes a device fold's accumulated partials may hold before they refold
#: into one (:meth:`MTRunner._mesh_reduce`).
_REFOLD_LANE_CAP = 1 << 20

#: Every kernel the device path launches, by name.
KERNELS = {"fnv": _fnv.KERNEL, "segfold": _segfold.KERNEL,
           "handoff": _handoff.KERNEL}

#: The handoff's counts each device sink keeps (``stats()["device"]
#: ["handoff"]``): table-program batches, classic batches dispatched while
#: the handoff was live, tokens that missed the vocabulary, and windows
#: that seeded it through the host codec.
_HANDOFF_COUNTS = ("table_batches", "classic_batches", "misses",
                   "host_bootstraps")

_I64_MAX = 2 ** 63 - 1


def _clone_op(op):
    """The per-job operator instance.  The stateless wrappers share
    themselves (``base._shared_instance_deepcopy``), so user callables
    are not descended into; lifecycle operators (BlockMapper,
    BlockReducer) and unknown user subclasses are deep-copied, so
    concurrent jobs never share their state."""
    return copy.deepcopy(op)


def _record_batches(chunk, B):
    """The chunk's records as parallel ``(keys, values)`` lists of at most
    ``B``: ``read_lists`` where the dataset has it, else slices of
    ``read()``."""
    reader = getattr(chunk, "read_lists", None)
    if reader is not None:
        return reader(B)

    def slices(it=iter(chunk.read())):
        while True:
            ks, vs = [], []
            for k, v in itertools.islice(it, B):
                ks.append(k)
                vs.append(v)
            if not ks:
                return
            yield ks, vs

    return slices()


def _run_record_chain(chain, batches, B, push, prof=None, prog=None,
                      qrec=None):
    """Run a record-op chain over ``batches`` through each op's
    ``apply_batch`` and push the survivors as ``B``-record blocks.

    Survivors accumulate across input batches, so a selective filter
    still emits full blocks; a ``FlatMap`` takes its input in slices sized
    to its observed fan-out, so ``B x fan-out`` records never exist at
    once.  Slices keep stream order, so results equal the streamed
    chain's.  With the per-operator profiler ``prof``, each op's
    ``apply_batch`` is timed once per batch under its index-prefixed
    label.

    ``prog``, a certified chain's lane program
    (:class:`.analyze.torchtrace.ChainProgram`), evaluates whole batches
    vectorized (the 64-bit host result decides; the device dispatch is
    verified per batch inside ``run_batch``); a batch outside its
    contract runs the chain.  The first vectorized batch is also run
    through the chain and compared: a divergence (int64 wrap, a
    dtype-sensitive UDF) drops the rest of the job back to the chain.

    With a fault plan installed or a quarantine recorder ``qrec`` (the
    job attempt's :class:`.faults.QuarantineAttempt`), each batch runs
    through the chain transactionally (the lane program stays off):
    the ``udf`` site checks it, and under quarantine its output stages
    locally and lands only on success, so a deterministic failure
    bisects down to the poison records, which go to ``qrec``; order is
    kept, so results equal a run whose input lacked them."""
    pk, pv = [], []
    labels = _profile.chain_labels(chain) if prof is not None else None

    def emit(ks, vs):
        pk.extend(ks)
        pv.extend(vs)
        while len(pk) >= B:
            push(Block.from_lists(pk[:B], pv[:B]))
            del pk[:B]
            del pv[:B]

    def run(ks, vs, start, emit=emit):
        for i in range(start, len(chain)):
            op = chain[i]
            if type(op) is base.FlatMap and len(ks) > 1024:
                n, at, step = len(ks), 0, 1024
                while at < n:
                    took = min(step, n - at)
                    t0 = time.perf_counter() if prof is not None else 0.0
                    sks, svs = op.apply_batch(ks[at:at + took],
                                              vs[at:at + took])
                    if prof is not None:
                        prof.op_add(labels[i], time.perf_counter() - t0,
                                    records=len(sks))
                    at += took
                    if sks:
                        fan = -(-len(sks) // took)
                        step = max(64, min(B, B // fan))
                        run(sks, svs, i + 1, emit)
                return
            if prof is None:
                ks, vs = op.apply_batch(ks, vs)
            else:
                t0 = time.perf_counter()
                ks, vs = op.apply_batch(ks, vs)
                prof.op_add(labels[i], time.perf_counter() - t0,
                            records=len(ks))
            if not ks:
                return
        emit(ks, vs)

    fa = _faults.active()
    if qrec is not None or fa is not None:
        def guarded_run(ks, vs):
            staged = []
            try:
                if fa is not None:
                    _faults.check_records("udf", ks, vs)
                run(ks, vs, 0, (lambda a, b: staged.append((a, b)))
                    if qrec is not None else emit)
            except Exception as e:
                if qrec is None or _faults.classify(e) != "deterministic":
                    raise
                if len(ks) <= 1:
                    qrec.add(_faults.run_context.get("stage"),
                             ks[0] if ks else None,
                             vs[0] if vs else None, e)
                    return
                with _trace.span("fault", "quarantine-bisect",
                                 records=len(ks)):
                    mid = len(ks) // 2
                    guarded_run(ks[:mid], vs[:mid])
                    guarded_run(ks[mid:], vs[mid:])
                return
            for sks, svs in staged:
                emit(sks, svs)

        for ks, vs in batches:
            guarded_run(ks, vs)
        if pk:
            push(Block.from_lists(pk, pv))
        return

    diffed = False
    for ks, vs in batches:
        out = prog.run_batch(ks, vs) if prog is not None else None
        if out is not None and not diffed:
            diffed = True
            staged = []
            run(ks, vs, 0, lambda a, b: staged.append((a, b)))
            rks = [k for a, _ in staged for k in a]
            rvs = [v for _, b in staged for v in b]
            prog.count("diff_checked")
            if rks != out[0] or rvs != out[1]:
                prog.count("diff_diverged")
                log.warning("lane program diverged from the per-record "
                            "chain on its first batch (%s); the job falls "
                            "back to the per-record path",
                            prog.spec.describe())
                prog = None
                out = (rks, rvs)
        if out is None:
            run(ks, vs, 0)
        else:
            emit(*out)
    if pk:
        push(Block.from_lists(pk, pv))


def _overlap_stream(items, store, size_of=None):
    """The overlap executor: run ``items`` (the codec, a generator whose
    ``next()`` reads, inflates, tokenizes or drives the device sink) on a
    producer thread that stays up to :data:`OVERLAP_WINDOWS` blocks
    ahead of the consumer (the fold/register loop on the job thread).

    Every block in flight is charged to the run's budget
    (``store.reserve_overlap``) from the moment the codec emits it until
    the consumer has folded it, so readahead displaces resident refs
    instead of stacking on them.  A producer exception is raised again on
    the consumer.  A consumer that stops early (a failed fold) stops the
    producer, joins it and releases every reservation still queued.

    A producer that does not stop within ``_PRODUCER_JOIN_SECONDS`` fails
    the run: it may still hold a budget charge or drive the device sink.

    Critical-path accounting, as in the JAX package: each produced block
    is one ``codec`` span on the producer's lane; while the consumer
    waits with its producer inside the native codec
    (``devtime.active_in``), the slot counts as stalled, and ``codec_wait``
    accumulates the wall-clock union of intervals where every live slot is
    stalled at once; each wait is one ``stall`` span.

    Returns ``items`` unchanged when the depth is 0 or there is no store."""
    depth = OVERLAP_WINDOWS
    if depth <= 0 or store is None:
        return items
    if size_of is None:
        size_of = lambda b: b.nbytes()  # noqa: E731
    # one codec span per produced block: the generator's next(), not the
    # queue wait (a pass-through when tracing is off)
    items = _trace.timed_iter(items, "codec", "codec-window")

    q = queue.Queue(maxsize=depth)
    stop = threading.Event()
    state = {"err": None, "done": False}
    end = object()

    def produce():
        try:
            for item in items:
                # a chaos schedule widens the producer/consumer shutdown
                # race here (``sleep_ms``)
                _faults.check("overlap_produce")
                if stop.is_set():
                    return
                if item is None:
                    continue  # the serial loop drops empty windows too
                nb = size_of(item) or 0
                _metrics.counter_add("overlap.windows", 1)
                if nb:
                    store.reserve_overlap(nb)
                while not stop.is_set():
                    try:
                        q.put((item, nb), timeout=0.05)
                        break
                    except queue.Full:
                        continue
                else:
                    if nb:
                        store.release_overlap(nb)
                    return
        except BaseException as e:  # raised again on the consumer
            state["err"] = e
        finally:
            state["done"] = True
            while not stop.is_set():
                try:
                    q.put((end, 0), timeout=0.05)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=produce, daemon=True,
                              name="dampr-codec")

    def drain():
        while True:
            try:
                _item, nb = q.get_nowait()
            except queue.Empty:
                return
            if nb:
                store.release_overlap(nb)

    def get():
        """The next queued ``(item, nb)``; a wait is a ``stall`` span, and
        counts toward ``codec_wait`` while the producer is in the codec
        (a sibling job's codec is not what this fold waits on)."""
        try:
            return q.get_nowait()
        except queue.Empty:
            pass
        wait_t0 = _trace.now()
        try:
            while True:
                stalled = devtime.active_in(thread.ident, "codec")
                if stalled:
                    devtime.slot_stall()
                try:
                    return q.get(timeout=0.05)
                except queue.Empty:
                    if state["done"] and q.empty():
                        return end, 0
                finally:
                    if stalled:
                        devtime.slot_unstall()
        finally:
            _trace.complete("stall", "pipe-wait", wait_t0)
            _metrics.counter_add("overlap.consumer_stalls", 1)

    def gen():
        thread.start()
        devtime.slot_enter()
        try:
            while True:
                item, nb = get()
                if item is end:
                    if state["err"] is not None:
                        raise state["err"]
                    return
                try:
                    yield item
                finally:
                    if nb:
                        store.release_overlap(nb)
        finally:
            devtime.slot_exit()
            stop.set()
            drain()
            deadline = time.perf_counter() + _PRODUCER_JOIN_SECONDS
            while thread.is_alive() and time.perf_counter() < deadline:
                # a producer still inside the codec: keep releasing what
                # it queues until it sees ``stop``
                drain()
                thread.join(timeout=0.05)
            drain()
            if thread.is_alive():
                _obslog.warn(
                    "overlap-producer-stuck",
                    "overlap producer thread %s did not stop within %s s",
                    thread.name, _PRODUCER_JOIN_SECONDS, logger=log,
                    thread=thread.name)
                raise RuntimeError(
                    "overlap producer {} did not stop within {} s".format(
                        thread.name, _PRODUCER_JOIN_SECONDS))

    return gen()


class _FoldDeclined(Exception):
    """:class:`_StreamFolder` control flow: this mapping keeps its
    original refs (an ineligible value dtype, or folding disabled while
    it ran)."""


class _StreamFolder(object):
    """The consumer half of a streamed map -> keyed-fold edge
    (:mod:`.plan.pipeline`): finished map jobs' partition mappings publish
    into a bounded queue, and a folder thread pre-folds each under the
    consuming reduce's associative op while the map stage still runs, so
    the reduce inherits compacted partials.

    Exactness: folding only regroups partials across jobs, and both
    reduce paths fold the exact hash groups and emit in key order, so for
    commutative ops no output changes.  Commutativity is gated per block
    on the records' dtype, the JAX package's rule: ``sum`` folds integer
    and bool values only (reordered float addition is not exact), min/max
    any numeric values.  The first ineligible block disables folding for
    the stage; the remaining mappings pass through untouched.

    Backpressure: ``publish`` runs on the dispatching thread after the
    job's result is in, and waits while the queued bytes would pass
    ``bound``.  Queued bytes are charged through ``store.reserve_overlap``
    (the spill admission sees them) and released as each mapping folds.
    A folder error never fails the run: its mappings keep their refs."""

    def __init__(self, store, op, bound, device=False):
        self.store = store
        self.op = op
        self.bound = max(1, int(bound))
        self.device = device
        self.folded = {}      # job idx -> replacement mapping
        self.fold_delta = {}  # pid -> staged bytes minus folded bytes
        self.stats = {"published": 0, "early_folded_blocks": 0,
                      "bytes_in": 0, "bytes_out": 0, "fold_seconds": 0.0,
                      "overlap_seconds": 0.0, "stall_seconds": 0.0,
                      "queue_peak_bytes": 0, "queue_depth_series": []}
        self._q = queue.Queue()
        self._cv = threading.Condition()
        self._pending = 0
        self._disabled = False
        self._t0 = time.perf_counter()
        self._pool_done_at = None
        self._thread = threading.Thread(
            target=self._run, name="dampr-pipefold", daemon=True)
        self._thread.start()

    def _sample_depth(self):
        # a bounded queue-depth series: every other sample goes once the
        # cap is reached, so it stays an even sketch of the stage
        series = self.stats["queue_depth_series"]
        series.append([round(time.perf_counter() - self._t0, 4),
                       self._pending])
        if len(series) > 512:
            del series[::2]

    def publish(self, idx, mapping):
        """Dispatch-thread side: charge, wait under the bound, enqueue.
        ``mapping`` is the job's ``{pid: [refs]}``; the folder may replace
        it whole in ``self.folded[idx]``."""
        _faults.check("stream_publish")
        if self._disabled:
            return
        nb = sum(ref.total_bytes for refs in mapping.values()
                 for ref in refs)
        if nb <= 0:
            return
        wait_t0 = 0.0
        with self._cv:
            while (self._pending > 0 and self._pending + nb > self.bound
                    and not self._disabled):
                if not wait_t0:
                    wait_t0 = _trace.now()
                self._cv.wait(0.05)
            if self._disabled:
                if wait_t0:
                    self.stats["stall_seconds"] += _trace.now() - wait_t0
                return
            self._pending += nb
            self.stats["queue_peak_bytes"] = max(
                self.stats["queue_peak_bytes"], self._pending)
            self._sample_depth()
        if wait_t0:
            self.stats["stall_seconds"] += _trace.now() - wait_t0
            _trace.complete("stall", "stream-wait", wait_t0)
        self.store.reserve_overlap(nb)
        self.stats["published"] += 1
        self.stats["bytes_in"] += nb
        self._q.put((idx, mapping, nb))

    def _value_dtype_ok(self, block):
        dt = getattr(getattr(block, "values", None), "dtype", None)
        if dt is None:
            return False
        if self.op.kind == "sum":
            return dt.kind in "iub"
        return dt.kind in "iubf"

    def _fold_one(self, mapping):
        """Fold one job mapping atomically: every pid folds into a fresh
        ref before any original drops, so a failure midway (or a dtype
        disable) leaves the original refs in place."""
        out = {}
        blocks_in = sum(len(refs) for refs in mapping.values())
        try:
            with _trace.span("pipeline", "early-fold", lane="pipeline",
                             blocks=blocks_in):
                for pid, refs in mapping.items():
                    if not refs:
                        continue
                    if self._disabled:
                        raise _FoldDeclined()
                    blocks = [r.get() for r in refs]
                    merged = (blocks[0] if len(blocks) == 1
                              else Block.concat(blocks))
                    del blocks
                    if not self._value_dtype_ok(merged):
                        # one dtype per stage output: off for the stage
                        with self._cv:
                            self._disabled = True
                            self._cv.notify_all()
                        raise _FoldDeclined()
                    folded = segment.fold_block(merged, self.op)
                    out[pid] = [self.store.register(folded,
                                                    device=self.device)]
        except BaseException as e:
            for refs in out.values():
                for r in refs:
                    self.store.drop_ref(r)
            if isinstance(e, _FoldDeclined):
                return None
            raise
        for pid, refs in mapping.items():
            if pid in out:
                self.stats["early_folded_blocks"] += len(refs)
                for r in refs:
                    self.store.drop_ref(r)
            else:
                out[pid] = list(refs)
        return out

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            idx, mapping, nb = item
            t0 = time.perf_counter()
            try:
                if not self._disabled:
                    with devtime.charging(self.store):
                        replacement = self._fold_one(mapping)
                    if replacement is not None:
                        self.folded[idx] = replacement
                        self.stats["bytes_out"] += sum(
                            ref.total_bytes for refs in replacement.values()
                            for ref in refs)
                        self._note_delta(mapping, replacement)
            except Exception:  # noqa: BLE001 - an optimization only: the
                #               originals stay registered
                _obslog.warn("early-fold-error",
                             "early-fold worker failed; disabling folding "
                             "for this stage (originals kept)",
                             logger=log, exc_info=True)
                with self._cv:
                    self._disabled = True
                    self._cv.notify_all()
            finally:
                dt = time.perf_counter() - t0
                self.stats["fold_seconds"] += dt
                if self._pool_done_at is None:
                    self.stats["overlap_seconds"] += dt
                self.store.release_overlap(nb)
                with self._cv:
                    self._pending = max(0, self._pending - nb)
                    self._sample_depth()
                    self._cv.notify_all()

    def _note_delta(self, mapping, replacement):
        """Per-pid staged-minus-folded bytes: the reduce's size gate (the
        tiny fold) decides on staged bytes, so the pipelined run takes
        the branch the staged one would."""
        for pid, refs in mapping.items():
            orig = sum(r.total_bytes for r in refs)
            now = sum(r.total_bytes for r in replacement.get(pid, ()))
            self.fold_delta[pid] = self.fold_delta.get(pid, 0) + max(
                0, orig - now)

    def mark_pool_done(self):
        """The map stage's jobs are done: fold seconds from here on no
        longer overlap map compute."""
        self._pool_done_at = time.perf_counter()

    def finish(self):
        """Drain, join, and return ``({idx: replacement}, stats)``."""
        self._q.put(None)
        self._thread.join(timeout=60.0)
        if self._thread.is_alive():
            # a wedged folder: its originals are still registered and
            # right; the daemon releases its reservations as it drains
            _obslog.warn("early-fold-stuck",
                         "early-fold worker did not drain within 60s; "
                         "using unfolded mappings", logger=log)
            with self._cv:
                self._disabled = True
                self._cv.notify_all()
            return {}, dict(self.stats)
        return dict(self.folded), dict(self.stats)


class _ChainedOutput(object):
    """The env entry of a streamed chain producer's output: its blocks
    went straight into the consumer's jobs and were dropped as each was
    consumed, so nothing materialized."""

    __slots__ = ("records",)

    def __init__(self, records):
        self.records = records

    def total_records(self):
        return self.records


class _SharedScanChunk(object):
    """One read of a tap chunk shared by the scan-fused map stages that
    materialize its bytes: the first ``read_bytes()`` reads, later readers
    (a streaming ``iter_byte_blocks`` one included) get the cached bytes.
    When nothing materializes, ``iter_byte_blocks`` is the chunk's own
    bounded scan, so fusion never raises the memory ceiling above what the
    widest member would use alone."""

    def __init__(self, chunk):
        self._chunk = chunk
        self._bytes = None

    def read_bytes(self):
        if self._bytes is None:
            self._bytes = self._chunk.read_bytes()
        return self._bytes

    def __getattr__(self, name):
        if name == "iter_byte_blocks" and self._bytes is not None:
            cached = self._bytes
            return lambda *a, **k: iter((cached,))
        return getattr(self._chunk, name)  # AttributeError if absent


#: The per-chunk job of one map stage and what its output collection needs
#: (:meth:`MTRunner._map_job`): ``new_sink()`` gives a ``(push, end)``
#: pair (push folds or collects one block; end registers the job's blocks
#: and returns its ``{pid: [refs]}``), ``window_sink()`` the stage's
#: window sink on its execution target, ``finish(sink, push, end)`` a
#: job's ``end()`` with its device sink's handoff refs joined in.
_MapJob = collections.namedtuple(
    "_MapJob", "job new_sink window_sink finish combine_op pin feeds_reduce "
    "sorted_runs dev_lowered feeds_device_fold handoff")


class OutputDataset(Dataset):
    """Final-output view over a PartitionSet: records in ascending key
    order, read down a ladder:

    1. under a third of the budget, one stable argsort of the output
       concatenated in ``all_refs()`` order (ties come in that order);
    2. a key-sorted run set streams a vectorized k-way merge over its runs,
       one window per run, so only this rung stays bounded over the
       budget;
    3. numeric keys sort every partition whole, then merge them in
       vectorized chunks;
    4. anything else (object keys) merges per-partition sorted streams
       record by record under :class:`~.dataset.OrderKey`, each partition
       concatenated and sorted whole first.

    Rungs 3 and 4 (and a single-partition output) hold every partition
    sorted in RAM at once, as the JAX package's single-device reads do."""

    def __init__(self, pset, store=None):
        self.pset = pset
        self.store = store

    def _partition_stream(self, pid):
        try:
            blk = self._sorted_partition_block(pid)
        except TypeError:
            # uncomparable mixed keys: a stable sort under the total-order
            # wrapper (the merge's order)
            blk = Block.concat([r.get() for r in self.pset.refs(pid)])
            keys = blk.keys
            order = np.asarray(
                sorted(range(len(blk)), key=lambda i: OrderKey(keys[i])),
                dtype=np.int64)
            blk = blk.take(order)
        if blk is None:
            return iter(())
        return blk.iter_pairs()

    def _sorted_concat(self):
        """One concat and one stable argsort of the whole output, or None
        when it should not run: its working copies peak near 3x the
        output, so it is gated at a third of the budget; uncomparable
        mixed keys bail too."""
        total = sum(r.nbytes for r in self.pset.all_refs())
        budget = (self.store.budget if self.store is not None
                  else settings.max_memory_per_stage)
        if total * 3 > budget:
            return None
        blk = Block.concat([r.get() for r in self.pset.all_refs()])
        if not len(blk):
            return blk
        try:
            order = np.argsort(blk.keys, kind="stable")
        except TypeError:
            return None
        return blk.take(order)

    def _merged_run_blocks(self):
        """A key-sorted run set through the vectorized k-way merge: one
        window per run in flight, every run file read front to back; the
        merge planner already capped the fan-in."""
        refs = [r for r in self.pset.all_refs() if len(r)]
        if not refs:
            return iter(())
        return merge_sorted_streams([r.iter_windows() for r in refs])

    def read(self):
        pids = sorted(self.pset.parts)
        if not pids:
            return iter(())
        if self.pset.key_sorted_runs:
            return itertools.chain.from_iterable(
                b.iter_pairs() for b in self.sorted_blocks())
        if len(pids) == 1:
            return self._partition_stream(pids[0])
        blk = self._sorted_concat()
        if blk is not None:
            return blk.iter_pairs()
        blocks = self._vector_merge_blocks(pids)
        if blocks is not None:
            return itertools.chain.from_iterable(
                b.iter_pairs() for b in blocks)
        return self._merge_partitions(pids)

    def _merge_partitions(self, pids):
        streams = [StreamDataset(self._partition_stream(pid)) for pid in pids]
        return merged_read(streams)

    def _sorted_partition_block(self, pid):
        blk = Block.concat([r.get() for r in self.pset.refs(pid)])
        if not len(blk):
            return None
        order = np.argsort(blk.keys, kind="stable")  # TypeError -> caller
        return blk.take(order)

    def _vector_merge_blocks(self, pids, chunk=1 << 16):
        """K-way merge of numeric-keyed partitions, each sorted whole (on a
        thread pool: numpy's sorts release the interpreter lock), emitted
        in bounded vectorized chunks; None when any key lane is object."""
        all_refs = [r for pid in pids for r in self.pset.refs(pid)]
        if any(r.key_dtype == object for r in all_refs):
            return None
        workers = max(1, min(settings.max_processes, len(pids)))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                sorted_parts = list(pool.map(self._sorted_partition_block,
                                             pids))
        else:
            sorted_parts = [self._sorted_partition_block(p) for p in pids]
        parts = [blk for blk in sorted_parts if blk is not None]
        if not parts:
            return iter(())
        return self._merge_sorted_parts(parts, chunk)

    @staticmethod
    def _merge_sorted_parts(parts, chunk=1 << 16):
        """Vectorized k-way merge over key-sorted blocks: each round takes
        the smallest chunk-boundary key as the bound, gathers every record
        below it (at most ``chunk`` per part) and stable-sorts only that
        slice; records equal to the bound follow as raw slices in part
        order, so ties keep the heap merge's order and a hot key streams."""
        parts = [p for p in parts if len(p)]

        def gen():
            pos = [0] * len(parts)
            n_parts = len(parts)
            while True:
                bound = None
                active = False
                for i in range(n_parts):
                    blk = parts[i]
                    if pos[i] >= len(blk):
                        continue
                    active = True
                    edge = min(pos[i] + chunk, len(blk)) - 1
                    k = blk.keys[edge]
                    if bound is None or k < bound:
                        bound = k
                if not active:
                    return
                pieces = []
                for i in range(n_parts):
                    blk = parts[i]
                    if pos[i] >= len(blk):
                        continue
                    end = int(np.searchsorted(blk.keys, bound, side="left"))
                    if end > pos[i]:
                        pieces.append(blk.slice(pos[i], end))
                        pos[i] = end
                if pieces:
                    merged = Block.concat(pieces)
                    yield merged.take(
                        np.argsort(merged.keys, kind="stable"))
                for i in range(n_parts):
                    blk = parts[i]
                    if pos[i] >= len(blk):
                        continue
                    end = int(np.searchsorted(blk.keys, bound, side="right"))
                    at = pos[i]
                    while at < end:
                        sub = min(at + chunk, end)
                        yield blk.slice(at, sub)
                        at = sub
                    pos[i] = end

        return gen()

    def sorted_blocks(self):
        """The key-sorted output as columnar blocks, down the same ladder
        as :meth:`read` (the record merge re-blocked at
        ``settings.batch_size``)."""
        blk = self._sorted_concat()
        if blk is not None:
            if len(blk):
                yield blk
            return
        if self.pset.key_sorted_runs:
            for b in self._merged_run_blocks():
                yield b
            return
        pids = sorted(self.pset.parts)
        blocks = self._vector_merge_blocks(pids)
        if blocks is not None:
            for b in blocks:
                yield b
            return
        builder = BlockBuilder(settings.batch_size)
        for k, v in self._merge_partitions(pids):
            out = builder.add(k, v)
            if out is not None:
                yield out
        out = builder.flush()
        if out is not None:
            yield out

    def delete(self):
        self.pset.delete(self.store)


class _SinkOutput(object):
    """A sink stage's result: its part files."""

    def __init__(self, paths):
        self.paths = paths

    def datasets(self):
        return [SinkDataset(p) for p in self.paths]


class StageStats(object):
    """Per-stage metrics, the JAX package's fields and the port's ``op``
    and ``launches``.  Spill counts are causal: a spill is charged to the
    stage whose registrations evicted the block, which an earlier stage
    may have produced.  ``records_in``/``bytes_in`` count the stage's
    materialized inputs (a tap's size is unknown until read: 0),
    ``bytes_out`` its output's host and device bytes or its part files'.
    ``retries`` and ``quarantined`` count the stage's job re-executions
    and poison records; ``shuffle_target`` holds what a run on one device
    gives (shuffle routing across devices is a later slice)."""

    __slots__ = ("stage_id", "kind", "op", "target", "shuffle_target",
                 "n_jobs", "records_in", "records_out", "bytes_in",
                 "bytes_out", "seconds", "spill_count", "spill_bytes",
                 "merge_gens", "merge_gen_bytes", "retries", "quarantined",
                 "launches")

    def __init__(self, stage_id, kind, op, target):
        self.stage_id = stage_id
        self.kind = kind
        self.op = op
        self.target = target
        self.shuffle_target = None
        self.n_jobs = 0
        self.records_in = 0
        self.records_out = 0
        self.bytes_in = 0
        self.bytes_out = 0
        self.seconds = 0.0
        self.spill_count = 0
        self.spill_bytes = 0
        self.merge_gens = 0
        self.merge_gen_bytes = 0
        self.retries = 0
        self.quarantined = 0
        self.launches = {}

    def as_dict(self):
        return {"stage": self.stage_id, "kind": self.kind, "op": self.op,
                "target": self.target, "jobs": self.n_jobs,
                "records_in": self.records_in,
                "records_out": self.records_out,
                "bytes_in": self.bytes_in, "bytes_out": self.bytes_out,
                "spill_count": self.spill_count,
                "spill_bytes": self.spill_bytes,
                "merge_gens": self.merge_gens,
                "merge_gen_bytes": self.merge_gen_bytes,
                "retries": self.retries,
                "quarantined": self.quarantined,
                "shuffle_target": self.shuffle_target,
                "seconds": self.seconds,
                # each kernel's launches during the stage (stages run one
                # at a time, so the counts are the stage's own)
                "launches": dict(self.launches)}


class MTRunner(object):
    """Sequential stage walk with parallel jobs within each stage."""

    def __init__(self, name, graph, n_maps=None, n_reducers=None,
                 n_partitions=None, memory_budget=None, resume=False):
        # The device is resolved up front: a run asked to use a card that
        # is absent fails here, before any stage, never on the CPU.
        self.device = settings.resolve_device()
        self.name = name
        self.graph = graph
        # durable per-stage checkpoints (:mod:`.resume`); "auto" is the
        # DSL's run-retry loop around a resumable runner
        self.resume = bool(resume)
        self.n_maps = n_maps or settings.max_processes
        self.n_reducers = n_reducers or settings.max_processes
        self.n_partitions = n_partitions or settings.partitions
        # an explicit partition count is pinned: history-driven sizing
        # (plan.cost) only retunes the default
        self._explicit_partitions = n_partitions is not None
        self.store = storage.RunStore(name, budget=memory_budget)
        self.stats = []
        self.plan_report = None
        self.run_summary = None
        self._lock = threading.Lock()
        self._device = {"batches": 0, "fallbacks": 0, "stream_seconds": 0.0,
                        "combine_seconds": 0.0,
                        "phases": dict.fromkeys(ops_lower.PHASES, 0.0),
                        "handoff": dict.fromkeys(_HANDOFF_COUNTS, 0)}
        # Producer stage ids whose output edge the plan marked
        # handoff="device" (plan.lower.apply sets it): their jobs keep the
        # counts on the device for the consuming fold.
        self._handoff_sids = set()
        # Streamed stage edges (plan.pipeline sets them): producer sid ->
        # {"mode", "dst"}.  Like _handoff_sids a dispatch hint, never a
        # stage option, so stage fingerprints do not depend on history.
        self._pipeline_edges = {}
        self._pipeline_stats = {
            "executed": 0, "degraded": 0, "published": 0,
            "early_folded_blocks": 0, "bytes_in": 0, "bytes_out": 0,
            "fold_seconds": 0.0, "overlap_seconds": 0.0,
            "stall_seconds": 0.0, "queue_peak_bytes": 0,
            "queue_depth_series": []}
        # a streamed chain's consumer results, computed at the producer's
        # turn: the consumer's turn takes them instead of running
        self._chain_results = {}
        # reduces that took _mesh_reduce's device fold
        self.mesh_folds = 0
        # reduce partitions that went out of core, by path
        self.streamed_assoc_folds = 0
        self.streamed_views = 0
        self.streamed_joins = 0
        # scan-shared groups: {"stages": [sid, ...], "chunks": n}
        self.scan_groups = []
        # reduces that took the tiny associative fold
        self.tiny_folds = 0
        # classified job re-executions and the backoff they slept
        self.retries_total = 0
        self._retry_lock = threading.Lock()
        self._backoff_seconds = 0.0
        # the poison-record sink (settings.max_quarantined > 0): records a
        # deterministic failure bisects out of the batched record path go
        # to <scratch>/<run>/quarantine.jsonl and the stage completes
        self._quarantine = (_faults.Quarantine(name,
                                               settings.max_quarantined)
                            if settings.max_quarantined > 0 else None)
        # the fault counters' epoch: stats()["faults"] reports this run's
        # share of the process-wide counts
        self._fault_snapshot = None
        #: which attempt of a ``run(resume="auto")`` this runner is (the
        #: failed ones before it are in ``stats()["faults"]``)
        self.run_attempt = 1
        # the observability plane, run-scoped (_start_obs/_stop_obs)
        self.tracer = None
        self.metrics = None
        self.profiler = None
        self.flightrec = None
        self.logstream = None
        self._sampler = None
        self._progress = None
        self._status = {}
        self._run_failed = False
        #: the torch.profiler Chrome trace of a ``settings.profile_dir`` run
        self.profile_trace_file = None

    # -- helpers -----------------------------------------------------------
    def _pool_map(self, fn, jobs, n_workers, label=None, on_result=None):
        """Run ``fn`` over ``jobs`` on a thread pool; every job's
        exception surfaces (results are read in order) and its keyed
        device calls are charged to this run's store.  ``label`` names
        each job's ``job`` span (on its worker's lane) when tracing; the
        profiler gets each job's thread-seconds, the metrics plane its
        start and end.  ``on_result(idx, result)`` (a streamed edge's
        publish) runs on this thread as each result comes in, in job
        order; it may wait, while the workers run ahead.

        Under ``settings.job_retries`` each job runs inside
        ``store.attempt()`` (a failed attempt's refs are dropped) and a
        failure retries as :meth:`_retrying` classifies it."""
        fn = self._retrying(fn, label or "job")

        def charged(j):
            with devtime.charging(self.store):
                return fn(j)

        if label is not None and _trace.enabled():
            inner_t = charged

            def charged(j):  # noqa: F811 - one job span per job
                with _trace.span("job", label):
                    return inner_t(j)

        prof = _profile.active()
        if prof is not None:
            inner_p = charged

            def charged(j):  # noqa: F811
                t0 = time.perf_counter()
                try:
                    return inner_p(j)
                finally:
                    prof.job_add(time.perf_counter() - t0)

        m = _metrics.active()
        if m is not None:
            st = self._status
            st["jobs_total"] = len(jobs)
            st["jobs_done"] = 0
            inner_m = charged

            def charged(j):  # noqa: F811
                m.counter_add("run.jobs_started", 1)
                try:
                    return inner_m(j)
                finally:
                    m.counter_add("run.jobs_done", 1)
                    st["jobs_done"] = st.get("jobs_done", 0) + 1

        def collect(results):
            out = []
            for r in results:
                if on_result is not None:
                    on_result(len(out), r)
                out.append(r)
            return out

        workers = max(1, min(n_workers, len(jobs)))
        if workers == 1:
            return collect(charged(j) for j in jobs)
        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="dampr-job") as pool:
            return collect(pool.map(charged, jobs))

    def _retrying(self, fn, label):
        """``fn`` under the classified job-retry loop
        (``settings.job_retries``; ``fn`` itself when 0): every attempt
        runs in ``store.attempt()``, so its registered refs, device lanes
        included, are dropped if it raises.  Fatal failures never retry;
        transient ones back off with full jitter (:func:`.faults.backoff`);
        deterministic ones retry at once (a stateful UDF may recover)."""
        retries = settings.job_retries
        if not retries:
            return fn

        def run(job):
            for attempt in range(retries + 1):
                try:
                    with self.store.attempt():
                        return fn(job)
                except Exception as e:
                    kind = _faults.classify(e)
                    if kind == "fatal" or attempt == retries:
                        raise
                    delay = (_faults.backoff(attempt)
                             if kind == "transient" else 0.0)
                    with self._retry_lock:
                        self.retries_total += 1
                        self._backoff_seconds += delay
                    _trace.instant("retry", label, attempt=attempt + 1,
                                   kind=kind)
                    log.warning(
                        "job failed (%s, attempt %d/%d), retrying%s",
                        kind, attempt + 1, retries + 1,
                        " in %.0f ms" % (delay * 1000) if delay else "",
                        exc_info=True)
                    if delay:
                        time.sleep(delay)
        return run

    def _as_chunks(self, entry):
        """Stage input -> list of job datasets."""
        if isinstance(entry, storage.PartitionSet):
            ds = [BlockDataset([ref]) for ref in entry.all_refs()]
            return ds if ds else [BlockDataset([])]
        if isinstance(entry, _SinkOutput):
            return entry.datasets()
        if not isinstance(entry, Chunker):
            raise TypeError("unknown stage input {!r}".format(entry))
        chunks = list(entry.chunks())
        return chunks if chunks else [BlockDataset([])]

    def _reduce_consumes(self, output, _seen=None):
        """Does a GReduce consume ``output``, directly or through identity
        map stages that copy it forward unchanged?  (Its input must arrive
        hash-routed, as hash-sorted runs.)"""
        seen = _seen if _seen is not None else set()
        if output in seen:
            return False
        seen.add(output)
        for s in self.graph.stages:
            if output not in s.inputs:
                continue
            if isinstance(s, GReduce):
                return True
            if (isinstance(s, GMap)
                    and type(s.mapper) is base.Map
                    and s.mapper.mapper is base._identity
                    and s.combiner is None
                    and "binop" not in s.options
                    and self._reduce_consumes(s.output, seen)):
                return True
        return False

    def _add_combine_seconds(self, secs):
        with self._lock:
            self._device["combine_seconds"] += secs

    def _note_device_sink(self, sink):
        with self._lock:
            dev = self._device
            dev["batches"] += sink.batches
            dev["fallbacks"] += sink.fallbacks
            dev["stream_seconds"] += sink.stream_seconds
            for k, v in sink.seconds.items():
                dev["phases"][k] += v
            for k in _HANDOFF_COUNTS:
                dev["handoff"][k] += getattr(sink, k)

    # -- map ---------------------------------------------------------------
    def _small_input(self, entry):
        """The refs of a materialized stage input within
        :data:`SMALL_STAGE_BYTES`, or None."""
        if not isinstance(entry, storage.PartitionSet):
            return None
        refs = list(entry.all_refs())
        if sum(r.total_bytes for r in refs) > SMALL_STAGE_BYTES:
            return None
        return refs

    def run_map(self, stage_id, stage, env):
        """One job per chunk of the first input; every other input (a
        cross's broadcast side) reaches each job whole, as a chunk list:
        ``mapper.map(chunk, *supplementary)``.

        The tiny-input collapse: a small materialized input to a pure
        record stream or a broadcast join runs as one job over all its
        refs, since per-job fixed costs dominate at that size.  Only where
        chunking is mechanical: a fused chain that embeds a
        ``StreamMapper`` keeps its per-chunk calls."""
        entries = [env[s] for s in stage.inputs]
        chunks = self._as_chunks(entries[0])
        supplementary = [self._as_chunks(e) for e in entries[1:]]
        if len(chunks) > 1 and (
                base.is_pure_record_stream(stage.mapper)
                or type(stage.mapper) in (base.MapCrossJoin,
                                          base.MapAllJoin)):
            refs = self._small_input(entries[0])
            if refs is not None:
                chunks = [BlockDataset(refs)]
        mj = self._map_job(stage, supplementary, stage_id)
        folder = self._stage_folder(stage_id, mj)
        replaced = {}
        try:
            results = self._pool_map(
                mj.job, chunks, self.n_maps, label="map",
                on_result=folder.publish if folder is not None else None)
        finally:
            close_readahead(chunks)
            if folder is not None:
                # drains on a failed stage too, so every queued
                # reservation is released
                folder.mark_pool_done()
                replaced, fstats = folder.finish()
                self._note_pipeline(stage_id, fstats)
        for idx, mapping in replaced.items():
            results[idx] = mapping
        pset = self._collect_partitions(results, mj)
        if folder is not None and folder.fold_delta:
            # the reduce's size gate decides on the bytes the staged run
            # would have had (_tiny_assoc_reduce)
            pset.pipeline_fold_delta = dict(folder.fold_delta)
        return pset, pset.total_records(), len(chunks)

    # -- streamed edges (plan.pipeline) -------------------------------------
    def _stage_folder(self, stage_id, mj):
        """The early folder of a streamed map -> keyed-fold edge, or None
        when the edge is not streamed or its producer's run mode rules it
        out (then the staged barrier holds)."""
        hint = self._pipeline_edges.get(stage_id)
        if hint is None or hint["mode"] != "early_fold":
            return None
        if not settings.pipeline_enabled():
            return None
        op = getattr(getattr(self.graph.stages[hint["dst"]], "reducer",
                             None), "op", None)
        degrade = None
        if mj.sorted_runs or mj.pin:
            degrade = "producer run mode incompatible"
        elif op is None or op.kind not in ("sum", "min", "max"):
            degrade = "consumer op not early-foldable"
        if degrade is not None:
            self._pipeline_stats["degraded"] += 1
            log.info("streamed edge s%s degraded to staged barrier: %s",
                     stage_id, degrade)
            return None
        bound = settings.pipeline_queue_bytes or max(
            1, self.store.budget // 4)
        self._pipeline_stats["executed"] += 1
        _trace.instant("pipeline", "streamed-edge", src=stage_id,
                       dst=hint["dst"], mode="early_fold")
        # folded partials register in the tier the originals went to, so
        # a device fold's input stays on the card (the HBM tier)
        return _StreamFolder(self.store, op, bound,
                             device=mj.feeds_device_fold)

    def _note_pipeline(self, stage_id, fstats):
        """Add one streamed edge's folder stats to the run's."""
        ps = self._pipeline_stats
        for k in ("published", "early_folded_blocks", "bytes_in",
                  "bytes_out", "fold_seconds", "overlap_seconds",
                  "stall_seconds"):
            ps[k] += fstats[k]
        ps["queue_peak_bytes"] = max(ps["queue_peak_bytes"],
                                     fstats["queue_peak_bytes"])
        series = ps["queue_depth_series"]
        series.extend([stage_id, t, b]
                      for t, b in fstats["queue_depth_series"])
        if len(series) > 1024:
            del series[: len(series) - 1024]

    def _run_chain(self, sid_p, stage_p, sid_c, env):
        """A streamed map -> map chain: the consumer's jobs run per
        finished producer partition block while the producer stage still
        runs, and the producer's output never materializes.

        Exactness: consumer results collect in the staged job order,
        (producer pid, producer job index), the order the staged walk of
        ``all_refs()`` feeds them in, and per-pid record order survives
        compaction's order-preserving concat either way.  Block
        boundaries differ, which the plan pass proved invisible (a pure
        record stream, nothing boundary-sensitive downstream).

        Returns (producer placeholder, records, jobs) for the producer's
        bookkeeping and keeps the consumer's result in
        ``self._chain_results[sid_c]``; None degrades to the barrier."""
        stage_c = self.graph.stages[sid_c]
        entries = [env[s] for s in stage_p.inputs]
        chunks = self._as_chunks(entries[0])
        supplementary = [self._as_chunks(e) for e in entries[1:]]
        mj_p = self._map_job(stage_p, supplementary, sid_p)
        mj_c = self._map_job(stage_c, [], sid_c)
        if any(mj.combine_op is not None or mj.pin or mj.feeds_reduce
               or mj.feeds_device_fold or mj.sorted_runs
               for mj in (mj_p, mj_c)):
            # the jobs disagree with the plan-time gates (a setting
            # changed between plan and run): the barrier is always right
            self._pipeline_stats["degraded"] += 1
            log.info("streamed edge s%s degraded to staged barrier: "
                     "job mode incompatible", sid_p)
            return None

        self._pipeline_stats["executed"] += 1
        _trace.instant("pipeline", "streamed-edge", src=sid_p, dst=sid_c,
                       mode="chain")
        futures = {}  # (producer pid, producer job idx) -> (future, refs)
        spans = []    # (t0, t1) per consumer job
        spans_lock = threading.Lock()
        acct = {"bytes_in": 0, "records_in": 0}

        def traced_c(ds):
            if _trace.enabled():
                with _trace.span("job", "chain"):
                    return mj_c.job(ds)
            return mj_c.job(ds)

        retried_c = self._retrying(traced_c, "chain")

        def job_c(ds):
            t0 = time.perf_counter()
            try:
                with devtime.charging(self.store):
                    return retried_c(ds)
            finally:
                with spans_lock:
                    spans.append((t0, time.perf_counter()))

        def publish(idx, mapping):
            _faults.check("stream_publish")
            self._pipeline_stats["published"] += 1
            for pid in sorted(mapping):
                refs = list(mapping[pid])
                if not refs:
                    continue
                acct["bytes_in"] += sum(r.total_bytes for r in refs)
                acct["records_in"] += sum(len(r) for r in refs)
                futures[(pid, idx)] = (
                    pool_c.submit(job_c, BlockDataset(refs)), refs)

        pool_c = ThreadPoolExecutor(
            max_workers=max(1, min(self.n_maps, settings.max_processes)),
            thread_name_prefix="dampr-chain")
        pool_done_at = None
        try:
            self._pool_map(mj_p.job, chunks, self.n_maps, label="map",
                           on_result=publish)
            pool_done_at = time.perf_counter()
            mappings_c = []
            for key in sorted(futures):
                fut, refs = futures[key]
                mappings_c.append(fut.result())
                for r in refs:
                    self.store.drop_ref(r)
        finally:
            pool_c.shutdown(wait=True)
            close_readahead(chunks)
        fold_s = sum(t1 - t0 for t0, t1 in spans)
        overlap_s = sum(max(0.0, min(t1, pool_done_at) - t0)
                        for t0, t1 in spans)
        self._note_pipeline(sid_p, {
            "published": 0, "early_folded_blocks": 0,
            "bytes_in": acct["bytes_in"],
            "bytes_out": sum(r.total_bytes for m in mappings_c
                             for refs in m.values() for r in refs),
            "fold_seconds": fold_s, "overlap_seconds": overlap_s,
            "stall_seconds": 0.0, "queue_peak_bytes": 0,
            "queue_depth_series": []})
        pset = self._collect_partitions(mappings_c, mj_c)
        self._chain_results[sid_c] = (
            pset, pset.total_records(), len(futures))
        return (_ChainedOutput(acct["records_in"]), acct["records_in"],
                len(chunks))

    def _pipeline_section(self):
        """``stats()["pipeline"]``: the plan's edge decisions and the
        folder and chain counters.  ``overlap_fraction`` is the share of
        the streamed consumers' seconds that ran while the producing
        stage's jobs were still running."""
        ps = self._pipeline_stats
        rep = ((self.plan_report or {}).get("pipeline") or {})
        fold_s = ps["fold_seconds"]
        return {
            "enabled": settings.pipeline_enabled(),
            "edges_streamed": rep.get("streamed", 0),
            "edges_barrier": rep.get("barriers", 0),
            "executed": ps["executed"],
            "degraded": ps["degraded"],
            "published": ps["published"],
            "early_folded_blocks": ps["early_folded_blocks"],
            "bytes_in": ps["bytes_in"],
            "bytes_out": ps["bytes_out"],
            "fold_seconds": round(fold_s, 4),
            "overlap_seconds": round(ps["overlap_seconds"], 4),
            "overlap_fraction": (round(ps["overlap_seconds"] / fold_s, 4)
                                 if fold_s > 1e-9 else 0.0),
            "stall_seconds": round(ps["stall_seconds"], 4),
            "queue_peak_bytes": ps["queue_peak_bytes"],
            "queue_depth_series": [[sid, round(t, 4), b]
                                   for sid, t, b
                                   in ps["queue_depth_series"]],
        }

    def _scan_share_group(self, sid, stage, env):
        """The later map stages that read the same tap as ``stage``: the
        members of one shared pass.  Only single-input stages over a tap
        (a ``Chunker``, where reading is the cost) qualify."""
        if len(stage.inputs) != 1:
            return []
        if not isinstance(env.get(stage.inputs[0]), Chunker):
            return []
        group = []
        for sjd in range(sid + 1, len(self.graph.stages)):
            s2 = self.graph.stages[sjd]
            if (isinstance(s2, GMap) and len(s2.inputs) == 1
                    and s2.inputs[0] == stage.inputs[0]):
                group.append((sjd, s2))
        return group

    def run_map_group(self, sids, stages, env):
        """Scan sharing: run several map stages over one pass of their
        common tap.

        When every member has a ``window_sink`` (the ``ops.text``
        scanners) and the chunk streams ``iter_byte_blocks``, one
        line-aligned window pass per chunk feeds every member's sink (a
        device-lowered member's is the device sink, so K1 and K2 run in
        the pass), on one producer thread of the overlap executor, and
        each emitted block goes into its member's fold/register pipeline.
        Otherwise (a BGZF chunk has no ``iter_byte_blocks``) the members
        that materialize bytes share one read of the chunk
        (:class:`_SharedScanChunk`, which holds the inflated chunk whole;
        byte-materializing members run before streaming ones) and
        per-record members read on their own.  The group's ``windowed``
        count says how many chunks took the window pass.  Returns one ``(pset, nrec, njobs)`` per stage, in order."""
        from .ops.text import _scan_windows

        chunks = self._as_chunks(env[stages[0].inputs[0]])
        parts = [self._map_job(s, [], sid) for sid, s in zip(sids, stages)]
        order = sorted(range(len(stages)), key=lambda i: bool(
            getattr(stages[i].mapper, "streams_bytes", False)))
        all_window = all(hasattr(s.mapper, "window_sink") for s in stages)

        def group_job(chunk):
            if not (all_window and hasattr(chunk, "iter_byte_blocks")):
                shared = (_SharedScanChunk(chunk)
                          if hasattr(chunk, "read_bytes") else chunk)
                outs = [None] * len(stages)
                for i in order:
                    outs[i] = parts[i].job(shared)
                return False, outs
            # sinks hold state, so the one producer thread owns them all
            members = [(mj.window_sink(),) + mj.new_sink() for mj in parts]

            def codec():
                for win in _scan_windows(chunk):
                    for mi, (wsink, _push, _end) in enumerate(members):
                        for blk in wsink.add(win) or ():
                            yield mi, blk
                for mi, (wsink, _push, _end) in enumerate(members):
                    for blk in wsink.finish() or ():
                        yield mi, blk

            gen = codec()
            prof = _profile.active()
            if prof is not None:
                # one window pass serves every member: its time goes once
                # to a label naming the fused scanners
                gen = prof.timed_iter(
                    gen, "scan:" + "+".join(
                        type(s.mapper).__name__ for s in stages),
                    records_of=lambda it: len(it[1]))
            try:
                for mi, blk in _overlap_stream(
                        gen, self.store,
                        size_of=lambda it: it[1].nbytes()):
                    members[mi][1](blk)
            except BaseException:
                for (wsink, _push, _end), mj in zip(members, parts):
                    if mj.dev_lowered:
                        wsink.abort()
                raise
            finally:
                for (wsink, _push, _end), mj in zip(members, parts):
                    if mj.dev_lowered:
                        self._note_device_sink(wsink)
            return True, [mj.finish(wsink, push, end) for
                          (wsink, push, end), mj in zip(members, parts)]

        try:
            results = self._pool_map(group_job, chunks, self.n_maps,
                                     label="map-group")
        finally:
            close_readahead(chunks)
        ret = []
        for i, mj in enumerate(parts):
            pset = self._collect_partitions(
                [outs[i] for _w, outs in results], mj)
            ret.append((pset, pset.total_records(), len(chunks)))
        # windowed: the chunks that took the one window pass; the others
        # shared one read of their bytes (a BGZF or gzip chunk is inflated
        # whole, outside the budget, as in the JAX package)
        windowed = sum(1 for w, _outs in results if w)
        with self._lock:
            self.scan_groups.append({"stages": list(sids),
                                     "chunks": len(chunks),
                                     "windowed": windowed})
        log.info("scan sharing: %d stages fused over one pass of %d chunks "
                 "(%d windowed)", len(stages), len(chunks), windowed)
        return ret

    def _map_job(self, stage, supplementary, sid=None):
        """The per-chunk job of one map stage (stage id ``sid``), with its
        push/end sink factory, window-sink factory and ``finish`` (shared
        with :meth:`run_map_group`) and what its output collection needs to
        know (:data:`_MapJob`)."""
        from .ops.text import _drive_windows

        combine_op = None
        if isinstance(stage.combiner, base.PartialReduceCombiner):
            combine_op = stage.combiner.op
        elif "binop" in stage.options:
            combine_op = segment.as_assoc_op(stage.options["binop"])
        P = self.n_partitions
        # the plan's cost layer may size this stage's blocks from history
        B = stage.options.get("batch_size") or settings.batch_size
        pin = bool(stage.options.get("memory"))
        feeds_reduce = self._reduce_consumes(stage.output)
        # Sorted-run mode: an output no reduce consumes needs no hash
        # fan-out (its readers re-order by key or stream refs whole), so
        # each job registers its chunk as ONE key-sorted run.  A job falls
        # back to hash fan-out when its keys are not uniformly numeric
        # (the ``_sorted`` marker records which happened).
        sorted_run_mode = (settings.sort_runs_enabled()
                           and combine_op is None
                           and not feeds_reduce
                           and not pin
                           and not supplementary)
        # claims() re-checks the mapper, so a foreign annotation can never
        # dispatch an op the program does not implement.
        dev_lowered = (stage.options.get("exec_target") == "device"
                       and ops_lower.claims(stage.mapper) is not None)
        # The HBM tier: an output a device-foldable reduce reads keeps its
        # integer value lanes on the device (the store gates on the lane
        # and the budget), so the fold reads them where they are.
        feeds_device_fold = (
            feeds_reduce and settings.use_device
            and any(isinstance(s, GReduce) and stage.output in s.inputs
                    and len(s.inputs) == 1
                    and isinstance(s.reducer, base.AssocFoldReducer)
                    and s.reducer.op.kind in ("sum", "min", "max")
                    for s in self.graph.stages))
        # A certified numeric chain (analyze.torchtrace): the batched
        # record path runs whole batches through one lane program.
        # stage_program certifies the chain again, so a stale annotation
        # can never dispatch an unknown op.
        lane_program = None
        if stage.options.get("exec_target") == "device" and not dev_lowered:
            from .analyze import torchtrace

            lane_program = torchtrace.stage_program(stage)
        # The handoff: this stage's edge keeps the lowered program's counts
        # on the device into the fold (plan.lower.handoff_analyze).
        stage_handoff = sid is not None and sid in self._handoff_sids
        identity = (type(stage.mapper) is base.Map
                    and stage.mapper.mapper is base._identity)

        def try_sorted_run(blocks):
            """Register this job's one key-sorted run, or None when the
            keys do not qualify (the caller fans out by hash)."""
            blocks = [b for b in blocks if len(b)]
            if not blocks:
                return {"_sorted": True}
            kdts = {b.keys.dtype for b in blocks}
            if len(kdts) != 1 or next(iter(kdts)).kind not in "iuf":
                return None
            if (next(iter(kdts)).kind == "f"
                    and any(np.isnan(b.keys).any() for b in blocks)):
                # NaN has no total order: it would break the k-way
                # merge's bound comparisons
                return None
            merged = blocks[0] if len(blocks) == 1 else Block.concat(blocks)
            merged = merged.take(np.argsort(merged.keys, kind="stable"))
            return {0: [self.store.register(merged)], "_sorted": True}

        def new_sink():
            """``(push, end)`` for one chunk job: push folds or collects a
            block, end registers the job's blocks and returns its
            ``{pid: [refs]}``."""
            raw, partials = [], []

            def push(blk):
                if blk is None or not len(blk):
                    return
                if combine_op is None:
                    raw.append(blk)
                    return
                _faults.check("fold")
                t0 = time.perf_counter()
                with _trace.span("fold", "partial-fold", records=len(blk)):
                    partials.append(segment.fold_block(blk, combine_op))
                    if len(partials) >= _PARTIAL_FANIN:
                        merged = segment.fold_block(Block.concat(partials),
                                                    combine_op)
                        del partials[:]
                        partials.append(merged)
                dt = time.perf_counter() - t0
                self._add_combine_seconds(dt)
                prof = _profile.active()
                if prof is not None:
                    prof.op_add("combine", dt, records=len(blk))

            def end():
                blocks = raw
                if combine_op is not None and partials:
                    t0 = time.perf_counter()
                    with _trace.span("fold", "final-fold"):
                        blocks = [segment.fold_block(Block.concat(partials),
                                                     combine_op)]
                    dt = time.perf_counter() - t0
                    self._add_combine_seconds(dt)
                    prof = _profile.active()
                    if prof is not None:
                        prof.op_add("combine", dt)
                if sorted_run_mode:
                    out = try_sorted_run(blocks)
                    if out is not None:
                        return out
                # Registered inside the job, so the budget holds while the
                # stage runs.  A block a reduce reads is a hash-sorted run
                # (fold outputs already are; the sort is stable, so equal
                # keys keep input order): over budget, the reduce streams a
                # k-way merge over such runs.
                out = {}
                for blk in blocks:
                    if combine_op is None and feeds_reduce:
                        blk = blk.sort_by_hash()
                    for pid, sub in blk.split_by_partition(P).items():
                        out.setdefault(pid, []).append(
                            self.store.register(sub, pin=pin,
                                                device=feeds_device_fold,
                                                handoff=stage_handoff))
                return out

            return push, end

        def device_sink(mapper):
            return ops_lower.device_window_sink(mapper, self.store,
                                                handoff=stage_handoff,
                                                jobs=self.n_maps)

        def window_sink():
            """The stage's window sink on its execution target."""
            mapper = _clone_op(stage.mapper)
            if dev_lowered:
                return device_sink(mapper)
            return mapper.window_sink()

        def finish(sink, push, end):
            """``end()`` of a job whose window sink was ``sink``: a device
            sink on a handoff edge registers the job's counts as device
            refs, which join the job's output (a degrade's flush block goes
            through ``push`` first, down the classic path)."""
            hmap = None
            if dev_lowered and sink is not None:
                fblocks, hmap = sink.finalize_handoff(self.store, P)
                for blk in fblocks:
                    push(blk)
            out = end()
            for pid, refs in (hmap or {}).items():
                out.setdefault(pid, []).extend(refs)
            return out

        quarantine = self._quarantine

        def job(chunk):
            mapper = _clone_op(stage.mapper)
            push, end = new_sink()
            # this attempt's quarantine recorder: its records land in the
            # run's sink only if the attempt succeeds, so a retried job
            # never counts one twice
            qrec = quarantine.attempt() if quarantine is not None else None
            use_blocks = (not supplementary and hasattr(mapper, "map_blocks")
                          and hasattr(chunk, "read_bytes"))
            ident_blocks = (not supplementary and identity
                            and hasattr(chunk, "iter_blocks"))
            chain = (base.record_op_chain(mapper)
                     if not supplementary and not dev_lowered
                     and not use_blocks and not ident_blocks else None)
            # the per-operator profiler: one None check per job
            prof = _profile.active()
            sink = None
            if dev_lowered and (hasattr(chunk, "read_bytes")
                                or hasattr(chunk, "iter_byte_blocks")):
                # The producer thread of the overlap executor drives the
                # sink (its copies and kernels queue on the sink's own
                # stream) while this thread folds and registers.
                sink = device_sink(mapper)
                try:
                    for blk in _overlap_stream(
                            _drive_windows(mapper, chunk, sink=sink),
                            self.store):
                        push(blk)
                except BaseException:
                    # nothing of this attempt may still run on the card
                    # when a retry starts, and its vocabulary is dropped
                    sink.abort()
                    raise
                finally:
                    self._note_device_sink(sink)
            elif use_blocks:
                blocks = mapper.map_blocks(chunk)
                if prof is not None:
                    # each window's scan and tokenize is the scanner's
                    blocks = prof.timed_iter(blocks,
                                             _profile.op_label(mapper, 0))
                for blk in _overlap_stream(blocks, self.store):
                    push(blk)
            elif ident_blocks:
                for blk in chunk.iter_blocks():
                    push(blk)
            elif chain is not None:
                _run_record_chain(chain, _record_batches(chunk, B), B, push,
                                  prof, lane_program, qrec)
            elif prof is not None and combine_op is None:
                # a generator chain does not decompose per op: the whole
                # stream under one label keeps the stage's coverage
                t0 = time.perf_counter()
                nrec = 0
                builder = BlockBuilder(B)
                for k, v in mapper.map(chunk, *supplementary):
                    nrec += 1
                    push(builder.add(k, v))
                push(builder.flush())
                prof.op_add("stream:" + _profile.op_label(mapper),
                            time.perf_counter() - t0, records=nrec)
            else:
                builder = BlockBuilder(B)
                for k, v in mapper.map(chunk, *supplementary):
                    push(builder.add(k, v))
                push(builder.flush())
            out = finish(sink, push, end)
            if qrec is not None:
                qrec.commit()
            return out

        return _MapJob(job, new_sink, window_sink, finish, combine_op, pin,
                       feeds_reduce, sorted_run_mode, dev_lowered,
                       feeds_device_fold, stage_handoff)

    def _collect_partitions(self, mappings, mj):
        """Per-chunk ``{pid: [refs]}`` job results of the map job ``mj``,
        in chunk order, into one PartitionSet.  In sorted-run mode it is
        flagged ``key_sorted_runs`` only when every job registered a
        sorted run, and its merge is planned; otherwise partitions holding
        too many blocks compact."""
        all_sorted = bool(mj.sorted_runs)
        sorted_runs = mj.sorted_runs
        # provenance: hash-routed unless the jobs ran as sorted runs, and
        # hash-sorted runs where a combine folded or a reduce reads them
        pset = storage.PartitionSet(
            self.n_partitions, hash_routed=not sorted_runs,
            hash_sorted=not sorted_runs and (mj.combine_op is not None
                                             or mj.feeds_reduce))
        for mapping in mappings:
            if sorted_runs and not mapping.pop("_sorted", False):
                all_sorted = False
            for pid, refs in mapping.items():
                for ref in refs:
                    pset.add(pid, ref)
        pset.key_sorted_runs = all_sorted
        if all_sorted and pset.parts:
            self._plan_sorted_merge(pset)
        else:
            self._compact_partitions(pset, mj.combine_op, mj.pin,
                                     mj.feeds_reduce,
                                     device=mj.feeds_device_fold,
                                     handoff=mj.handoff)
        return pset

    def _effective_merge_fanin(self, runs):
        """``settings.merge_fanin``, clamped so the k-way merge's working
        set (one buffered window per run plus its frame readahead, sized
        from the runs' bytes per record) fits the budget."""
        total = sum(max(1, r.nbytes) for r in runs)
        nrec = sum(len(r) for r in runs)
        window = max(1, int(total / max(1, nrec)) * storage.SPILL_WINDOW)
        per_run = (2 + storage.SPILL_READ_PREFETCH) * window
        cap = max(4, int(self.store.budget // per_run))
        return max(2, min(settings.merge_fanin, cap))

    def _plan_sorted_merge(self, pset):
        """Merge planning for a key-sorted run set (the external sort).
        Under the fan-in cap nothing happens: the final read merges the
        first-level runs, whose single spill is all that hits the disk.
        Past it, generations merge runs file to file (one window per
        source, the output written as it merges) until the count fits:
        only the smallest runs, just enough of them to get under the cap,
        in groups that merge concurrently on a pool whose size divides the
        fan-in, so the concurrent merges' windows stay inside what the
        clamp budgeted."""
        runs = [r for r in pset.all_refs() if len(r)]
        if not runs:
            return
        fanin = self._effective_merge_fanin(runs)
        gen = 0
        while len(runs) > fanin:
            workers = max(1, min(settings.max_processes, 8, fanin // 2))
            group_cap = max(2, fanin // workers)
            need = len(runs) - fanin
            m = max(1, -(-need // (group_cap - 1)))
            touched = need + m
            if touched > len(runs):
                # far over the cap: every run merges, in groups of
                # group_cap, and the loop runs again
                touched = len(runs)
                m = -(-touched // group_cap)
            runs.sort(key=lambda r: r.nbytes)
            to_merge = runs[:touched]
            keep = runs[touched:]
            groups = [g for g in (to_merge[i::m] for i in range(m)) if g]
            if _metrics.enabled():
                _metrics.counter_add("merge.generations", 1)
                _metrics.gauge_set("merge.runs", len(runs))
                for g in groups:
                    _metrics.observe("merge.fanin", len(g))
            log.info("sorted-run merge generation: %d runs over fan-in %d; "
                     "merging the %d smallest in %d group(s)", len(runs),
                     fanin, touched, len(groups))

            def merge_group(group):
                if len(group) == 1:
                    return group[0]
                merged = self.store.register_stream(merge_sorted_streams(
                    [r.iter_windows() for r in group]))
                for r in group:
                    self.store.drop_ref(r)
                return merged

            # each generation on its own lane; its groups' merge-run spans
            # land on their workers' lanes
            with _trace.span("merge", "generation {}".format(gen),
                             lane="merge gen {}".format(gen),
                             runs=len(runs), fanin=fanin,
                             groups=len(groups)):
                if len(groups) > 1 and workers > 1:
                    with ThreadPoolExecutor(
                            max_workers=min(workers, len(groups))) as pool:
                        merged = list(pool.map(merge_group, groups))
                else:
                    merged = [merge_group(g) for g in groups]
            gen += 1
            runs = keep + merged
        pset.parts = {0: runs}

    def _compact_partitions(self, pset, combine_op, pin, feeds_reduce,
                            device=False, handoff=False):
        """Block-count governor: a partition holding more than
        :data:`MAX_FILES_PER_STAGE` refs merges them in rounds of at
        most that many (re-folding under the stage's associative op, or
        re-sorting by hash when a reduce reads it, so runs stay runs).
        Each round's sources drop before its merged block registers, so
        residency stays one round over the budget at most.  A merged
        block of a device fold's input goes back to the device tier
        (``device``; at any size on a handoff edge): its sources' fetch is
        the governor's one host round trip per round."""
        limit = MAX_FILES_PER_STAGE
        for pid, refs in list(pset.parts.items()):
            if len(refs) > limit:
                _trace.instant("merge", "compact", partition=pid,
                               blocks=len(refs))
            while len(refs) > limit:
                merged_refs = []
                for at in range(0, len(refs), limit):
                    round_refs = refs[at:at + limit]
                    if len(round_refs) == 1:
                        merged_refs.append(round_refs[0])
                        continue
                    blocks = [r.get() for r in round_refs]
                    for r in round_refs:
                        self.store.drop_ref(r)
                    merged = Block.concat(blocks)
                    del blocks
                    if combine_op is not None:
                        merged = segment.fold_block(merged, combine_op)
                    elif feeds_reduce:
                        merged = merged.sort_by_hash()
                    merged_refs.append(self.store.register(
                        merged, pin=pin, device=device or handoff,
                        handoff=handoff))
                refs = merged_refs
            pset.parts[pid] = refs

    # -- reduce ------------------------------------------------------------
    def _tiny_assoc_reduce(self, stage, entries):
        """The small associative fold: every partition folds in one pass
        over the concatenated refs (``sort_and_group`` then
        ``fold_sorted``), then the result re-splits by the same hash % P.
        Each key's partition is unchanged; only the per-partition fixed
        costs go.  The output is the per-partition reducer's
        ``(k, (k, acc))`` records in hash order within a partition.  None
        when the stage does not qualify: one input, an associative fold,
        within :data:`SMALL_STAGE_BYTES` and the streaming threshold."""
        if len(entries) != 1 or not isinstance(stage.reducer,
                                               base.AssocFoldReducer):
            return None
        refs = list(entries[0].all_refs())
        thr = settings.streaming_reduce_threshold
        if thr is None:
            thr = self.store.budget
        # A streamed edge's early folds shrank the refs: gate on the bytes
        # the staged run had, since this path's (hash-order) layout
        # differs from the per-partition jobs'.
        staged_extra = sum(getattr(entries[0], "pipeline_fold_delta",
                                   {}).values())
        if (staged_extra + sum(r.total_bytes for r in refs)
                > min(SMALL_STAGE_BYTES, thr)):
            return None
        P = self.n_partitions
        merged = Block.concat([r.get() for r in refs])
        if not len(merged):
            return storage.PartitionSet(P, hash_routed=True,
                                        hash_sorted=True), 0, 1
        folded = segment.fold_sorted(segment.sort_and_group(merged),
                                     stage.reducer.op)
        h1, h2 = folded.hashes()
        pset, nrec = self._emit_keyed_fold(
            folded.keys, folded.values, h1, h2,
            bool(stage.options.get("memory")))
        with self._lock:
            self.tiny_folds += 1
        return pset, nrec, 1

    def _mesh_reduce(self, stage, entries):
        """The device fold of an associative sum/min/max reduce whose
        input holds device-resident refs (the HBM tier, the handoff): the
        refs' lanes fold where they are, host refs window by window after
        one upload each, partials refold on the device, and one fetch of
        the distinct keys' results ends the stage, in one pass over every
        partition.  Host memory holds one window and the key table.

        The counterpart of the reference's ``_mesh_reduce``.  It runs on
        one device until the multi-card slice (ROADMAP A5); on one device
        the reference's collective program degenerates to the local fold
        (:mod:`.parallel.shuffle`), and so does this.  As in the
        reference on one device, a reduce with nothing device-resident
        returns None (the host folds are cheaper).  None too wherever the
        host path is needed for exactness: object or float values, a
        running absolute sum past int64, a 64-bit key collision, or a key
        table past a quarter of the budget."""
        if (not settings.use_device or len(entries) != 1
                or not isinstance(stage.reducer, base.AssocFoldReducer)):
            return None
        op = stage.reducer.op
        if op.kind not in ("sum", "min", "max"):
            return None
        refs = list(entries[0].all_refs())
        if not any(r.is_device for r in refs):
            return None
        if any(r.value_dtype == object for r in refs):
            return None
        from .blocks import _concat_cols
        from .ops.hashing import combine64
        from .parallel.shuffle import (compact_partial, mesh_keyed_fold,
                                       mesh_keyed_refold)

        dev = self.device
        window_budget = max(1 << 20, self.store.budget // 4)
        acc_budget = max(1 << 20, self.store.budget // 4)

        class _HostPath(Exception):
            pass

        # The distinct-key table: hash-sorted (u64, key) segments, each
        # window's new keys one segment, equal-size neighbours merged
        # pairwise (the logarithmic method: every key takes part in
        # O(log W) linear merges, never a rebuild per window).
        kt = {"segs": [], "n": 0}
        partials = []  # folded (h1, h2, v, ok) lanes on the device

        def keys_equal(a, b):
            if a.dtype != object and b.dtype != object:
                return bool(np.all(a == b))
            return all(x == y for x, y in zip(a, b))

        def merge_segs(a, b):
            """One allocation merging two disjoint sorted segments."""
            ua, ka = a
            ub, kb = b
            n = len(ua) + len(ub)
            tgt = np.searchsorted(ua, ub) + np.arange(len(ub))
            ou = np.empty(n, dtype=np.uint64)
            mask = np.ones(n, dtype=bool)
            mask[tgt] = False
            ou[tgt] = ub
            ou[mask] = ua
            if ka.dtype != kb.dtype:
                allk = _concat_cols([ka, kb])
                ka, kb = allk[:len(ka)], allk[len(ka):]
            ok = np.empty(n, dtype=ka.dtype)
            ok[tgt] = kb
            ok[mask] = ka
            return ou, ok

        def merge_table(keys, h1, h2):
            """Fold one window's (hash -> key) pairs into the table,
            checking that equal 64-bit hashes carry equal keys."""
            u = combine64(h1, h2)
            worder = np.argsort(u, kind="stable")
            su = u[worder]
            sk = np.asarray(keys).take(worder)
            first = np.empty(len(su), dtype=bool)
            first[0] = True
            np.not_equal(su[1:], su[:-1], out=first[1:])
            dup = np.flatnonzero(~first)
            if len(dup) and not keys_equal(sk.take(dup), sk.take(dup - 1)):
                raise _HostPath  # a 64-bit collision in the window
            keep = np.flatnonzero(first)
            su = su[keep]
            sk = sk.take(keep)
            new_mask = np.ones(len(su), dtype=bool)
            for eu, ek in kt["segs"]:
                pos = np.minimum(np.searchsorted(eu, su), len(eu) - 1)
                exists = eu[pos] == su
                hit = np.flatnonzero(exists & new_mask)
                if len(hit) and not keys_equal(sk.take(hit),
                                               ek.take(pos[hit])):
                    raise _HostPath  # a 64-bit collision across windows
                new_mask &= ~exists
            idx = np.flatnonzero(new_mask)
            if len(idx):
                kt["segs"].append((su[idx], sk.take(idx)))
                kt["n"] += len(idx)
                while (len(kt["segs"]) > 1
                       and len(kt["segs"][-2][0])
                       <= 2 * len(kt["segs"][-1][0])):
                    b = kt["segs"].pop()
                    a = kt["segs"].pop()
                    kt["segs"].append(merge_segs(a, b))
            if kt["n"] * 80 > acc_budget:
                raise _HostPath  # extreme cardinality: stream on the host

        def table_compact():
            while len(kt["segs"]) > 1:
                b = kt["segs"].pop()
                a = kt["segs"].pop()
                kt["segs"].append(merge_segs(a, b))
            if kt["segs"]:
                return kt["segs"][0]
            return np.empty(0, dtype=np.uint64), np.empty(0, dtype=object)

        # Lane safety across windows, tracked on the host where the values
        # last were: a margined float64 absolute sum bounds every partial
        # of a sum within int64, and the scan lowering needs every value
        # non-negative.
        acc = {"abs": 0.0, "nonneg": True}

        def account(lane_abs, lane_min):
            if op.kind == "sum":
                acc["abs"] += float(lane_abs) * (1 + 1e-6) + 1
                if acc["abs"] > _I64_MAX:
                    raise _HostPath  # the sum could wrap: exact on host
            if lane_min < 0:
                acc["nonneg"] = False

        def compact():
            f = compact_partial(mesh_keyed_refold(partials, op.kind,
                                                  nonneg=acc["nonneg"]))
            del partials[:]
            partials.append(f)

        def maybe_compact():
            # by lane volume: a handoff ref is vocabulary-sized, so many
            # small partials cost less to hold than to refold
            if len(partials) > 1 and (
                    len(partials) >= 256
                    or sum(int(p[0].shape[0]) for p in partials)
                    >= _REFOLD_LANE_CAP):
                compact()

        def flush(win_blocks):
            blk = Block.concat(win_blocks)
            if not len(blk):
                return
            vals = blk.values
            if vals.ndim != 1 or not (vals.dtype == np.bool_
                                      or vals.dtype.kind in "iu"):
                raise _HostPath  # composite or float lanes fold on host
            if vals.dtype == np.uint64 and int(vals.max()) > _I64_MAX:
                raise _HostPath  # past the int64 lanes: exact on host
            v64 = vals.astype(np.int64)
            account(np.abs(v64.astype(np.float64)).sum(), int(v64.min()))
            h1, h2 = blk.hashes()
            merge_table(blk.keys, h1, h2)
            partials.append(mesh_keyed_fold(h1, h2, v64, op.kind,
                                            device=dev))
            self.store.count_h2d(16 * len(blk))
            maybe_compact()

        def flush_dev(ref):
            """One device ref into the fold with no host copy of its
            lanes: they join the partials as they are, the key table
            merges from the ref's host metadata, the lane bounds come from
            its registration."""
            import torch

            dv, dh1, dh2 = ref.device_lanes()
            keys, h1, h2 = ref.host_meta()
            account(ref.lane_abs, ref.lane_min)
            merge_table(keys, h1, h2)
            partials.append((dh1, dh2, dv, torch.ones(
                dv.shape[0], dtype=torch.int32, device=dv.device)))
            maybe_compact()

        try:
            win, wbytes = [], 0
            dev_folds = 0
            for ref in refs:
                if ref.is_device and len(ref):
                    flush_dev(ref)
                    dev_folds += 1
                    continue
                for w in ref.iter_windows():
                    if not len(w):
                        continue
                    win.append(w)
                    wbytes += w.nbytes()
                    if wbytes >= window_budget:
                        flush(win)
                        win, wbytes = [], 0
            if win:
                flush(win)
            if not partials:
                return storage.PartitionSet(self.n_partitions,
                                            hash_routed=True,
                                            hash_sorted=True), 0, 1
            if len(partials) > 1:
                compact()
        except _HostPath:
            log.info("device fold: taking the host path")
            return None

        # one fetch for the whole reduce: the final partial's live rows
        # (the refolds queued on the card finish here: the stage's final
        # fold, as the host path's final-fold span)
        with _trace.span("fold", "final-fold"):
            rh1, rh2, rv, rok = partials[0]
            mask = rok == 1
            with devtime.track("device"):
                fh1 = rh1[mask].cpu().numpy().view(np.uint32)
                fh2 = rh2[mask].cpu().numpy().view(np.uint32)
                fv = rv[mask].cpu().numpy()
            self.store.count_d2h(fh1.nbytes + fh2.nbytes + fv.nbytes)
            # hash -> key join against the table (every output hash
            # entered it with its window)
            tu, tk = table_compact()
            fu = combine64(fh1, fh2)
            idx = np.minimum(np.searchsorted(tu, fu), len(tu) - 1)
            if not bool(np.all(tu[idx] == fu)):
                raise RuntimeError("device fold lost a key")
        pset, nrec = self._emit_keyed_fold(
            tk.take(idx), fv, fh1, fh2, bool(stage.options.get("memory")))
        with self._lock:
            self.mesh_folds += 1
        log.info("device fold: %d keys from %d device refs", nrec, dev_folds)
        return pset, nrec, 1

    def _emit_keyed_fold(self, keys, vals, h1, h2, pin):
        """A keyed fold result as a stage output in the reduce-output
        contract: ``(k, (k, acc))`` records, numpy scalars unboxed, split
        by the hash % P, each partition in the fold's (hash) order."""
        P = self.n_partitions
        kl = pylist(keys)
        vl = pylist(vals)
        vcol = np.empty(len(kl), dtype=object)
        for i in range(len(kl)):
            vcol[i] = (kl[i], vl[i])
        # hash-routed by the split; the fold's order within a partition is
        # not an (h1, h2)-sorted run
        pset = storage.PartitionSet(P, hash_routed=True)
        nrec = 0
        for pid, sub in Block(keys, vcol, h1, h2).split_by_partition(
                P).items():
            nrec += len(sub)
            pset.add(pid, self.store.register(sub, pin=pin))
        return pset, nrec

    def run_reduce(self, stage_id, stage, env):
        """One job per partition id, empty partitions included (a
        ``StreamReducer`` runs on every one).  The inputs are
        co-partitioned by the same hash and ``P``.  A partition within the
        streaming threshold hands the reducer one in-memory
        :class:`~.base.GroupedView` per input (groups in key order); over
        it, the out-of-core paths take it (module docstring).  The output
        registers under the job's pid, keyed as the reducer emitted."""
        entries = [env[s] for s in stage.inputs]
        for e in entries:
            if not isinstance(e, storage.PartitionSet):
                raise TypeError(
                    "reduce inputs must be materialized partitions, got "
                    "{!r}".format(e))
        fast = self._mesh_reduce(stage, entries)
        if fast is not None:
            return fast
        fast = self._tiny_assoc_reduce(stage, entries)
        if fast is not None:
            return fast
        threshold = settings.streaming_reduce_threshold
        if threshold is None:
            threshold = self.store.budget
        # The streaming views yield groups in hash order: fine for reducers
        # whose groups are independent, but a Stream/BlockReducer sees the
        # group sequence, so it always gets the key-ordered view.
        order_insensitive = isinstance(
            stage.reducer, (base.Reduce, base.AssocFoldReducer))
        joinable = isinstance(
            stage.reducer, (base.KeyedInnerJoin, base.KeyedLeftJoin,
                            base.KeyedOuterJoin))

        def note(counter):
            with self._lock:
                setattr(self, counter, getattr(self, counter) + 1)

        def streaming_assoc_fold(refs, op):
            """Over-budget associative fold, vectorized: fold each window
            as it streams and compact the partials, so the working set is
            one accumulator of *distinct keys*, not the partition.  None
            (the caller streams records instead) once that accumulator
            outgrows the threshold."""
            partials = []

            def compact():
                merged = segment.fold_block(Block.concat(partials), op)
                del partials[:]
                partials.append(merged)
                return merged.nbytes()

            for ref in refs:
                for window in ref.iter_windows():
                    if not len(window):
                        continue
                    partials.append(segment.fold_block(window, op))
                    if len(partials) >= _PARTIAL_FANIN:
                        if compact() > threshold:
                            return None
            if not partials:
                return iter(())
            note("streamed_assoc_folds")
            final = segment.fold_sorted(
                segment.sort_and_group(Block.concat(partials)), op)
            gkeys = final.keys
            try:
                order = np.argsort(gkeys, kind="stable")
            except TypeError:
                order = np.arange(len(final))

            def emit():
                vals = final.values
                for gi in order:
                    k = gkeys[gi]
                    v = vals[gi]
                    k = k.item() if isinstance(k, np.generic) else k
                    v = v.item() if isinstance(v, np.generic) else v
                    yield k, (k, v)

            return emit()

        def records(pid):
            if joinable and len(entries) == 2:
                size = sum(r.total_bytes for pset in entries
                           for r in pset.refs(pid))
                if size > threshold:
                    # over-budget join partition: a hash-ordered merge
                    # join, bounded by its largest join-key group
                    log.info("partition %d join (%.1f MB) exceeds the "
                             "streaming threshold: merging by hash order",
                             pid, size / 1e6)
                    note("streamed_joins")
                    return base.streaming_merge_join(
                        base.StreamingGroupedView(entries[0].refs(pid)),
                        base.StreamingGroupedView(entries[1].refs(pid)),
                        _clone_op(stage.reducer))
            if len(entries) == 1:
                prefs = entries[0].refs(pid)
                if (sum(r.total_bytes for r in prefs) > threshold
                        and isinstance(stage.reducer, base.AssocFoldReducer)
                        and stage.reducer.op.kind is not None):
                    stream = streaming_assoc_fold(prefs, stage.reducer.op)
                    if stream is not None:
                        return stream
            views = []
            for pset in entries:
                refs = pset.refs(pid)
                part_bytes = sum(r.total_bytes for r in refs)
                if (len(entries) == 1 and order_insensitive
                        and part_bytes > threshold):
                    # out-of-core partition: one window per run resident
                    log.info("partition %d (%.1f MB) exceeds the streaming "
                             "threshold: groups will stream in hash order",
                             pid, part_bytes / 1e6)
                    note("streamed_views")
                    views.append(base.StreamingGroupedView(refs))
                else:
                    views.append(base.GroupedView([r.get() for r in refs]))
            return _clone_op(stage.reducer).reduce(*views)

        def job(pid):
            builder = BlockBuilder(settings.batch_size)
            refs = []
            prof = _profile.active()
            if prof is None:
                for k, v in records(pid):
                    blk = builder.add(k, v)
                    if blk is not None:
                        refs.append(self.store.register(blk))
            else:
                # a reducer does not decompose per op: grouping, the
                # user's reduce and the registration under one label
                t0 = time.perf_counter()
                nrec = 0
                for k, v in records(pid):
                    nrec += 1
                    blk = builder.add(k, v)
                    if blk is not None:
                        refs.append(self.store.register(blk))
                prof.op_add("reduce:" + _profile.op_label(stage.reducer),
                            time.perf_counter() - t0, records=nrec)
            blk = builder.flush()
            if blk is not None:
                refs.append(self.store.register(blk))
            return pid, refs

        P = self.n_partitions
        n_reducers = stage.options.get("n_reducers", self.n_reducers)
        results = self._pool_map(job, list(range(P)), n_reducers,
                                 label="reduce")
        pset = storage.PartitionSet(P)
        for pid, refs in results:
            for ref in refs:
                pset.add(pid, ref)
        return pset, pset.total_records(), P

    # -- sink --------------------------------------------------------------
    def run_sink(self, stage_id, stage, env):
        """One part file per chunk.  A small materialized input collapses
        to one chunk, as in :meth:`run_map`: the sinker is a fused record
        stream, so its chunking is mechanical."""
        entry = env[stage.inputs[0]]
        chunks = self._as_chunks(entry)
        if (len(chunks) > 1
                and type(stage.sinker) in (base.Map, base.ComposedMapper)):
            refs = self._small_input(entry)
            if refs is not None:
                chunks = [BlockDataset(refs)]
        os.makedirs(stage.path, exist_ok=True)

        def job(args):
            i, chunk = args
            part = os.path.join(stage.path, "part-{}".format(i))
            n = 0
            prof = _profile.active()
            t0 = time.perf_counter() if prof is not None else 0.0
            with open(part, "w", encoding="utf-8") as f:
                for _k, v in stage.sinker.map(chunk):
                    f.write("{}\n".format(v))
                    n += 1
            if prof is not None:
                prof.op_add("sink:" + _profile.op_label(stage.sinker),
                            time.perf_counter() - t0, records=n)
            return part, n

        try:
            results = self._pool_map(job, list(enumerate(chunks)),
                                     self.n_maps, label="sink")
        finally:
            close_readahead(chunks)
        return (_SinkOutput([p for p, _ in results]),
                sum(n for _, n in results), len(chunks))

    # -- observability -------------------------------------------------------
    def _register_gauges(self):
        """The pull gauges the sampler reads, installed once per run: the
        paths whose state they expose pay nothing."""
        m = self.metrics
        sto = self.store
        m.register_gauge("store.resident_bytes",
                         lambda: sto._resident_bytes)
        m.register_gauge(
            "store.budget_occupancy",
            lambda: (sto._resident_bytes / sto.budget) if sto.budget
            else 0.0)
        m.register_gauge("store.overlap_bytes", lambda: sto._overlap_bytes)
        m.register_gauge("store.hbm_bytes", lambda: sto._dev_bytes)
        m.register_gauge("store.spilled_bytes", lambda: sto.spilled_bytes)

        def _writer(attr):
            w = sto._writer
            return 0 if w is None else getattr(w, attr)

        m.register_gauge("writer.queue_depth",
                         lambda: _writer("_outstanding"))
        m.register_gauge("writer.inflight_bytes",
                         lambda: _writer("inflight_bytes"))
        m.register_gauge("overlap.live_slots", devtime.live_slots)
        m.register_gauge("overlap.stalled_slots", devtime.stalled_slots)
        m.register_gauge(
            "run.active_jobs",
            lambda: m.counters.get("run.jobs_started", 0)
            - m.counters.get("run.jobs_done", 0))

    def _start_obs(self):
        """Run-scoped observability: the flight recorder (tracing or
        metrics on), the structured log, the tracer (``settings.trace``),
        the profiler (``settings.profile``), the metrics registry and its
        sampler (``effective_metrics_interval_ms() > 0``) and the progress
        line (``settings.progress``).  Returns the flight recorder."""
        from .obs import flightrec as _flightrec

        interval = settings.effective_metrics_interval_ms()
        rec = None
        if settings.trace or interval > 0:
            # a crashdump describes the latest run under this name
            _flightrec.clear_stale(self.name)
            if _flightrec.RING_EVENTS > 0:
                rec = _flightrec.FlightRecorder(self.name,
                                                _flightrec.RING_EVENTS)
                self.flightrec = rec
                _flightrec.start(rec)
        lvl = settings.effective_log_level()
        if lvl or rec is not None:
            # events.jsonl when a level is in force, else the recorder's
            # WARN+ tail only
            path = None
            if lvl and _obslog.EVENTS_MAX > 0:
                from .obs import export as _export

                tdir = _export.run_trace_dir(self.name)
                os.makedirs(tdir, exist_ok=True)
                path = os.path.join(tdir, _obslog.FILE)
            self.logstream = _obslog.LogStream(
                self.name, rank=0, level=lvl or "warn", path=path,
                recorder=rec)
            _obslog.start(self.logstream)
            _obslog.info("run-start", "run %s started", self.name,
                         partitions=self.n_partitions)
        if settings.trace:
            self.tracer = _trace.Tracer(self.name)
            self.tracer.recorder = rec
            _trace.start(self.tracer)
        if settings.profile:
            self.profiler = _profile.Profiler(self.name)
            _profile.start(self.profiler)
        if interval > 0:
            from .obs import progress as _progress
            from .obs.metrics import Metrics
            from .obs.sampler import Sampler

            self.metrics = Metrics(self.name)
            if self.tracer is not None:
                # one clock: counter events share the tracer's epoch
                self.metrics.epoch = self.tracer.epoch
            self._register_gauges()
            _metrics.start(self.metrics)
            self._sampler = Sampler(self.metrics, interval, recorder=rec)
            self._sampler.start()
            if settings.progress:
                self._progress = _progress.ProgressReporter(
                    self.metrics, lambda: dict(self._status),
                    _progress.INTERVAL_MS)
                self._progress.start()
        return rec

    def _stop_obs(self):
        from .obs import flightrec as _flightrec

        if self._progress is not None:
            self._progress.stop()
            self._progress = None
        if self._sampler is not None:
            self._sampler.stop()
            self._sampler = None
        if self.metrics is not None:
            _metrics.stop(self.metrics)
        if self.tracer is not None:
            _trace.stop(self.tracer)
        if self.profiler is not None:
            _profile.stop(self.profiler)
        if self.flightrec is not None:
            _flightrec.stop(self.flightrec)

    def _torch_profile(self):
        """``settings.profile_dir``: the run under ``torch.profiler``
        (CPU, plus CUDA on a CUDA run), its Chrome trace exported to
        :attr:`profile_trace_file` once the run returns.  The profiler
        starts before the run's clock and stops after it, so its own
        start-up is not in the run's wall.  A CUDA run whose profiler
        cannot record the card raises: before it starts when CUDA
        activity is unsupported, after it ends when kernels launched and
        the trace holds no device event."""
        import contextlib

        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CPU]
        if cuda:
            if ProfilerActivity.CUDA not in \
                    torch.profiler.supported_activities():
                raise RuntimeError(
                    "settings.profile_dir: this torch cannot profile CUDA "
                    "activity, and a CPU-only trace of a CUDA run would "
                    "hide the card")
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(settings.profile_dir, exist_ok=True)
        path = os.path.join(settings.profile_dir, "{}.pt.trace.json".format(
            self.name.replace("/", "_")))
        launches0 = {k: kern.launches for k, kern in KERNELS.items()}

        @contextlib.contextmanager
        def hatch():
            self.profile_trace_file = path
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            try:
                yield
            finally:
                # a failed run's trace is written too
                prof.stop()
                prof.export_chrome_trace(path)
            launched = sum(kern.launches - launches0[k]
                           for k, kern in KERNELS.items())
            if cuda and launched and not any(
                    e.device_type == DeviceType.CUDA for e in prof.events()):
                raise RuntimeError(
                    "settings.profile_dir: the run launched {} kernels and "
                    "torch.profiler recorded no CUDA event".format(launched))

        return hatch()

    # -- the walk ----------------------------------------------------------
    def run(self, outputs):
        """Execute the graph; returns one dataset per requested output.
        Intermediate stage outputs are deleted once the walk ends (a
        resumable run releases their residency and keeps their
        checkpoints).  A failed run discards its queued spill writes
        (their refs keep their RAM blocks, no temp file stays), releases
        its device lanes and then flushes the flight recorder to
        ``crashdump.json``; SIGTERM takes the same path.  The summary
        (``run_summary``, ``em.stats()``) is built either way, and a
        traced run persists it with its trace."""
        # a fresh fault schedule per run (chaos runs replay exactly); the
        # counter epoch scopes stats()["faults"] to this run
        _faults.configure_for_run()
        self._fault_snapshot = _faults.counters_snapshot()
        _faults.set_context(run=self.name)
        restore_sigterm = self._install_sigterm()
        try:
            if settings.profile_dir:
                with self._torch_profile():
                    return self._run_observed(outputs)
            return self._run_observed(outputs)
        finally:
            if restore_sigterm is not None:
                try:
                    restore_sigterm()
                except (ValueError, OSError):
                    pass
            _faults.set_context(run=None, stage=None)

    def _install_sigterm(self):
        """While a run is in flight, SIGTERM raises ``SystemExit(143)`` on
        the main thread, so an external kill takes the failed run's path
        (writes aborted, device lanes released, crashdump flushed).  Only
        from the main thread and only where no handler is installed;
        returns the restore function or None."""
        import signal

        if threading.current_thread() is not threading.main_thread():
            return None
        try:
            prev = signal.getsignal(signal.SIGTERM)
            if prev is not signal.SIG_DFL:
                # the application owns SIGTERM (a handler, SIG_IGN, or one
                # installed outside Python): never clobber it
                return None

            def _on_term(signum, frame):
                raise SystemExit(143)  # 128 + SIGTERM

            signal.signal(signal.SIGTERM, _on_term)
        except (ValueError, OSError):
            return None
        return lambda: signal.signal(signal.SIGTERM, prev)

    def _run_observed(self, outputs):
        wall_start = time.time()
        t_start = time.perf_counter()
        epoch = devtime.epoch()
        launches0 = {k: kern.launches for k, kern in KERNELS.items()}
        rec = self._start_obs()
        try:
            return self._run_guarded(outputs)
        except BaseException as e:
            self._run_failed = True
            if self.logstream is not None:
                # the terminal record, before the flush, so the dump's log
                # tail names the death (the exception is raised again: no
                # stdlib line here)
                self.logstream.emit(
                    "error", "run-failed",
                    "run {} failed: {}: {}".format(
                        self.name, type(e).__name__, str(e)[:500]),
                    data={"exception": type(e).__name__})
            if rec is not None:
                if self._sampler is not None:
                    # one last sample: the dump shows the state at death
                    self._sampler.stop()
                    self._sampler = None
                rec.flush("run-failed", e)
            raise
        finally:
            self._stop_obs()
            try:
                self._finalize_obs(wall_start,
                                   time.perf_counter() - t_start,
                                   devtime.delta(epoch), launches0)
            except Exception:
                log.warning("stats/trace finalize failed", exc_info=True)
            finally:
                if self.logstream is not None:
                    _obslog.stop(self.logstream)
                    self.logstream = None

    def _run_guarded(self, outputs):
        from . import resume as _resume

        # Every run holds its scratch root's liveness lock (a named root is
        # shared across runs, resumable or not): the sweep of blocks no
        # manifest references runs only when the exclusive probe proves no
        # other live run is mid-flight under this name.
        guard = _resume.RunGuard(self.store.root)
        try:
            if guard.exclusive:
                _resume.gc_unreferenced(self.store.root)
            guard.share()
            return self._run(outputs)
        except BaseException:
            try:
                self.store.abort_writes()
            except Exception:
                log.warning("spill writer abort failed", exc_info=True)
            # a failed run's device lanes will never be read: they go, and
            # the device budget returns to 0
            try:
                self.store.release_device()
            except Exception:
                log.warning("device release failed", exc_info=True)
            raise
        finally:
            guard.close()
            self.store.stop_writes()

    def _entry_io(self, entry):
        """``(records, bytes)`` of a stage input or output: exact for
        materialized partitions and sink part files (records unknown),
        ``(None, None)`` for a tap, unknown until read."""
        if isinstance(entry, storage.PartitionSet):
            recs = nbytes = 0
            for r in entry.all_refs():
                recs += len(r)
                nbytes += r.total_bytes
            return recs, nbytes
        if isinstance(entry, _SinkOutput):
            nbytes = 0
            for p in entry.paths:
                try:
                    nbytes += os.path.getsize(p)
                except OSError:
                    pass
            return None, nbytes
        return None, None

    def _pressure_snap(self):
        """Store and retry counters at a stage boundary: their deltas are
        the stage's pressure fields."""
        sto = self.store
        q = self._quarantine
        return (sto.spill_count, sto.spilled_bytes, sto.merge_gens,
                sto.merge_gen_bytes, self.retries_total,
                q.count if q is not None else 0)

    def _fill_stage_io(self, st, stage, env, result, snap):
        for src in stage.inputs:
            r, b = self._entry_io(env.get(src))
            if r:
                st.records_in += r
            if b:
                st.bytes_in += b
        _r, b = self._entry_io(result)
        if b:
            st.bytes_out += b
        sto = self.store
        st.spill_count = sto.spill_count - snap[0]
        st.spill_bytes = sto.spilled_bytes - snap[1]
        st.merge_gens = sto.merge_gens - snap[2]
        st.merge_gen_bytes = sto.merge_gen_bytes - snap[3]
        st.retries = self.retries_total - snap[4]
        q = self._quarantine
        st.quarantined = (q.count - snap[5]) if q is not None else 0

    def _alias_provenance_ok(self, stage, src):
        """May an identity checkpoint alias ``src`` instead of running its
        copy stage?  The copy would hash-route every record and register
        hash-sorted runs, invariants a consuming reduce depends on
        (partition-local grouping, the over-budget streaming merge).  So
        the alias stands only when no reduce consumes the output (directly
        or through further identity checkpoints), or the input already
        carries both invariants (a map stage's output).  A reduce's output
        is registered under its job's pid whatever keys the reducer
        emitted: ``X.partition_reduce(f).checkpoint().partition_reduce(g)``
        aliasing f's output would leave g grouping each key only within
        f's partitions, silently wrong."""
        if not self._reduce_consumes(stage.output):
            return True
        return src.hash_routed and src.hash_sorted

    def _needed_stages(self, outputs, restorable):
        """The stage ids a resumable run must execute: a stage runs only
        if its output feeds one that runs (or is requested, or is a sink)
        and it was not restored, so a rerun whose intermediates were
        cleaned up does not recompute the chain below a surviving
        checkpoint."""
        required = set()
        needed = set(outputs)
        for sid in range(len(self.graph.stages) - 1, -1, -1):
            stage = self.graph.stages[sid]
            if isinstance(stage, GInput):
                continue
            if stage.output not in needed and not isinstance(stage, GSink):
                continue
            required.add(sid)
            if sid not in restorable:
                needed.update(stage.inputs)
        return required

    def _run(self, outputs):
        from . import resume as _resume

        self.graph, self.plan_report = plan.prepare(self.graph, outputs,
                                                    runner=self)
        rep = self.plan_report
        _trace.instant("plan", "optimize", lane="stages",
                       stages_before=rep.get("stages_before"),
                       stages_after=rep.get("stages_after"),
                       rules={k: v for k, v in
                              (rep.get("rules") or {}).items() if v})
        sto = self.store
        env = {}
        to_delete = []
        fused = {}  # scan-shared members' results, by stage id
        n_stages = len(self.graph.stages)
        restorable, stage_fps = {}, {}
        volatile_sources = set()
        required = None  # None: every stage runs
        if self.resume:
            # the partition count shapes every stage's output layout, so
            # it salts the fingerprints
            stage_fps = _resume.stage_fingerprints(
                self.graph, salt="p{}".format(self.n_partitions))
            restorable = _resume.load_plan(sto.root, stage_fps)
            if restorable:
                log.info("resume: %d stage(s) restorable from %s",
                         len(restorable), sto.root)
            required = self._needed_stages(outputs, restorable)
        for sid, stage in enumerate(self.graph.stages):
            if isinstance(stage, GInput):
                env[stage.output] = stage.tap
                continue
            t0 = time.perf_counter()
            t0_span = _trace.now()
            sto.set_stage(sid)
            # the stage the quarantine sink tags its records with
            _faults.set_context(run=self.name, stage=sid)
            snap = self._pressure_snap()
            stage_launches0 = {k: kern.launches
                               for k, kern in KERNELS.items()}
            kind = ("map" if isinstance(stage, GMap) else
                    "reduce" if isinstance(stage, GReduce) else "sink")
            if self.profiler is not None:
                self.profiler.begin_stage(
                    sid, plan.ir.stage_kind(stage),
                    provenance=plan.ir.stage_provenance(stage))
            if _metrics.enabled():
                # the progress line's stage, and stage boundaries in the
                # sampled series
                self._status.update({
                    "sid": sid + 1, "n_stages": n_stages, "kind": kind,
                    "stage_t0": time.time(), "jobs_total": 0,
                    "jobs_done": 0})
                _metrics.gauge_set("run.stage", sid)
            if required is not None and sid not in required:
                log.info("stage %d skipped: every consumer was restored "
                         "from its checkpoint", sid)
                continue
            if sid in restorable:
                result, nrec = _resume.restore_stage(sto.root,
                                                     restorable[sid])
                env[stage.output] = result
                if not isinstance(stage, GSink):
                    to_delete.append(stage.output)
                self._stage_done(sid, stage, "resumed-" + kind, env, result,
                                 nrec, 0, t0, t0_span, snap, stage_launches0)
                continue
            if isinstance(stage, GMap):
                src = env.get(stage.inputs[0])
                if (sid not in fused and sid not in self._chain_results
                        and len(stage.inputs) == 1
                        and type(stage.mapper) is base.Map
                        and stage.mapper.mapper is base._identity
                        and stage.combiner is None
                        and "binop" not in stage.options
                        and not stage.options.get("memory")
                        and not self.resume
                        and stage.inputs[0] not in outputs
                        and isinstance(src, storage.PartitionSet)
                        and src.n_partitions == self.n_partitions
                        and self._alias_provenance_ok(stage, src)):
                    # an identity checkpoint over a materialized partition
                    # set: alias it instead of copying every byte through
                    # a copy stage; the alias takes over its deletion
                    if stage.inputs[0] in to_delete:
                        to_delete.remove(stage.inputs[0])
                    env[stage.output] = src
                    to_delete.append(stage.output)
                    self._stage_done(sid, stage, "map-alias", env, src,
                                     src.total_records(), 0, t0, t0_span,
                                     snap, stage_launches0)
                    continue
                hint = self._pipeline_edges.get(sid)
                chained = None
                if (sid not in self._chain_results and sid not in fused
                        and hint is not None and hint["mode"] == "chain"
                        and settings.pipeline_enabled()):
                    chained = self._run_chain(sid, stage, hint["dst"], env)
                if sid in self._chain_results:
                    # a streamed chain's consumer: its jobs ran at the
                    # producer's turn, overlapped with the producer's
                    result, nrec, njobs = self._chain_results.pop(sid)
                elif chained is not None:
                    result, nrec, njobs = chained
                    kind = "map-chained"
                elif sid in fused:
                    result, nrec, njobs = fused.pop(sid)
                else:
                    group = [g for g in self._scan_share_group(
                        sid, stage, env)
                        if g[0] not in restorable
                        and (required is None or g[0] in required)]
                    if group:
                        members = [(sid, stage)] + group
                        outs = self.run_map_group(
                            [m for m, _ in members],
                            [st for _, st in members], env)
                        for (msid, _), out in zip(members[1:], outs[1:]):
                            fused[msid] = out
                        result, nrec, njobs = outs[0]
                    else:
                        result, nrec, njobs = self.run_map(sid, stage, env)
                to_delete.append(stage.output)
            elif isinstance(stage, GReduce):
                result, nrec, njobs = self.run_reduce(sid, stage, env)
                to_delete.append(stage.output)
            elif isinstance(stage, GSink):
                result, nrec, njobs = self.run_sink(sid, stage, env)
            else:
                raise TypeError("unknown stage type {!r}".format(stage))
            env[stage.output] = result
            # the stage-boundary write barrier: every spill this stage
            # queued has landed (and a failed write raises here), so the
            # checkpoint below sees settled refs
            sto.drain_writes()
            if self.resume:
                _resume.persist_stage(sto, sid, stage_fps[sid], result, nrec)
                if _resume.is_volatile(stage_fps[sid]):
                    volatile_sources.add(stage.output)
            self._stage_done(sid, stage, kind, env, result, nrec, njobs, t0,
                             t0_span, snap, stage_launches0)

        ret = []
        for source in outputs:
            entry = env[source]
            if isinstance(entry, storage.PartitionSet):
                ret.append(OutputDataset(entry, sto))
            elif isinstance(entry, _SinkOutput):
                ret.append(CatDataset(entry.datasets()))
            else:
                ret.append(CatDataset(list(entry.chunks())))
        keep = set(outputs)
        for source in to_delete:
            entry = env.get(source)
            # a chained producer's placeholder holds nothing to delete; an
            # alias of a kept output shares its partition set
            if (source in keep
                    or not isinstance(entry, storage.PartitionSet)
                    or any(env.get(k) is entry for k in keep)):
                continue
            if self.resume and source not in volatile_sources:
                # a durable run keeps its checkpoints (a changed rerun
                # resumes from the longest valid prefix) and frees their
                # residency now
                entry.release(sto)
            else:
                entry.delete(sto)
        sto.drain_writes()
        return ret

    def _stage_done(self, sid, stage, kind, env, result, nrec, njobs, t0,
                    t0_span, snap, launches0):
        """One finished (or restored, or aliased) stage's stats, span and
        log line."""
        op = (stage.mapper if isinstance(stage, GMap) else
              stage.reducer if isinstance(stage, GReduce) else stage.sinker)
        st = StageStats(sid, kind, plan.ir.chain_name(op),
                        stage.options.get("exec_target", "host"))
        st.n_jobs = njobs
        st.records_out = nrec
        st.seconds = time.perf_counter() - t0
        self._fill_stage_io(st, stage, env, result, snap)
        st.launches = {k: kern.launches - launches0[k]
                       for k, kern in KERNELS.items()}
        self.stats.append(st)
        _trace.complete("stage", "s{}:{}".format(sid, kind), t0_span,
                        lane="stages", records=nrec, jobs=njobs)
        log.info("stage %d done: %s", sid, st.as_dict())

    def _faults_section(self):
        """``stats()["faults"]``: this run's share of the process-wide
        retry and injection counters, its quarantine and backoff."""
        injected, io_retries, io_backoff = _faults.counters_delta(
            self._fault_snapshot)
        q = self._quarantine
        fplan = _faults.active()
        section = {
            "enabled": fplan is not None,
            "job_retries": self.retries_total,
            "io_retries": dict(io_retries),
            "retries": self.retries_total + sum(io_retries.values()),
            "backoff_seconds": round(self._backoff_seconds + io_backoff, 4),
            "quarantined": q.count if q is not None else 0,
            "max_quarantined": settings.max_quarantined,
        }
        if q is not None and q.count:
            section["quarantine_file"] = q.path
        if self.run_attempt > 1:
            # an auto-resumed run: the attempts that failed before it
            section["run_attempt"] = self.run_attempt
            section["failed_attempts"] = self.run_attempt - 1
        if fplan is not None:
            section["plan"] = fplan.spec
            section["injected"] = dict(injected)
        return section

    def _finalize_obs(self, wall_start, wall, dev, launches0):
        """Build the run summary (``em.stats()``, the stats.json payload)
        in the JAX package's shape, with the port's own device keys; a
        traced run also writes trace.json and stats.json under its trace
        directory.  Built on failure too."""
        from .obs import export as _export

        dstate = self._device
        sto = self.store
        rep = self.plan_report or {}
        stages = [s.as_dict() for s in self.stats]
        phases = dict(dstate["phases"])

        def frac(x):
            return x / wall if wall > 0 else 0.0

        def mbps(nbytes, secs):
            return nbytes / 1e6 / secs if secs > 1e-9 else 0.0

        device = {
            "device": str(self.device),
            "device_stages": rep.get("device_stages", 0),
            "lowered": bool((rep.get("lowering") or {}).get("enabled")),
            # devtime's device bucket over wall: host thread-seconds at
            # the dispatch and result sites (jobs overlap: it can pass 1)
            "device_fraction": frac(dev.get("device", 0.0)),
            "device_seconds": dev.get("device", 0.0),
            # summed per-batch stream spans on the card over wall time
            "stream_fraction": frac(dstate["stream_seconds"]),
            "stream_seconds": dstate["stream_seconds"],
            # the device sink's host seconds per phase (enqueue + wait is
            # the host driving the card)
            "host_phase_seconds": phases,
            "batches": dstate["batches"],
            "fallbacks": dstate["fallbacks"],
            "h2d_bytes": sto.h2d_bytes,
            "d2h_bytes": sto.d2h_bytes,
            "kernels": {k: kern.launches - launches0[k]
                        for k, kern in KERNELS.items()},
            # the HBM tier and the handoff: device edges the plan marked,
            # device bytes registered with no host round trip, the drain
            # bytes table batches never fetched, degrades to the spill
            # path, the most device bytes held, offloads to the host, and
            # the reduces that folded on the device (_mesh_reduce)
            "handoff_edges": rep.get("handoff_edges", 0),
            "handoff_bytes": sto.handoff_bytes,
            "d2h_avoided_bytes": sto.d2h_avoided_bytes,
            "handoff_degrades": sto.handoff_degrades,
            "hbm_peak_bytes": sto.hbm_peak_bytes,
            "hbm_offloads": sto.hbm_offloads,
            "mesh_folds": self.mesh_folds,
            "handoff": dict(dstate["handoff"]),
            # the keyed batch ops' device calls (hash lanes, sort, segment
            # fold): calls and host seconds summed over jobs; their bytes
            # are in h2d_bytes/d2h_bytes
            "keyed": {k: dict(v) for k, v in sto.keyed.items()},
        }
        # Spill I/O: bytes on disk and thread-seconds on the writer and
        # reader pools, and the seconds jobs waited on them (write side:
        # the writer pool's cap; read side: a frame not yet prefetched)
        io = {
            "spill_write_bytes": sto.spill_disk_bytes,
            "spill_write_seconds": sto.spill_write_seconds,
            "spill_write_mbps": mbps(sto.spill_disk_bytes,
                                     sto.spill_write_seconds),
            "spill_read_bytes": sto.spill_read_bytes,
            "spill_read_seconds": sto.spill_read_seconds,
            "spill_read_mbps": mbps(sto.spill_read_bytes,
                                    sto.spill_read_seconds),
            "io_wait_seconds": sto.io_wait_seconds,
            "io_wait_fraction": frac(sto.io_wait_seconds),
            "io_wait_write_seconds": sto.io_wait_write_seconds,
            "io_wait_write_fraction": frac(sto.io_wait_write_seconds),
            "writer_threads": settings.spill_write_threads,
            "read_prefetch": storage.SPILL_READ_PREFETCH,
            "inflight_peak_bytes": sto.spill_inflight_peak_bytes,
            "writer_queue_peak": sto.spill_queue_peak,
            # the overlap executor's codec blocks in flight, charged to
            # the budget: the most at once, and what is left (always 0)
            "overlap_windows": OVERLAP_WINDOWS,
            "overlap_peak_bytes": sto.overlap_peak_bytes,
            "overlap_bytes": sto.overlap_bytes,
            "budget_bytes": sto.budget,
        }
        summary = {
            "schema": _export.STATS_SCHEMA,
            "run": self.name,
            "process": _export.process_section(),
            "started_at": round(wall_start, 3),
            "wall_seconds": wall,
            "n_partitions": self.n_partitions,
            "stages": stages,
            "totals": {
                "records_out": sum(s["records_out"] for s in stages),
                "bytes_out": sum(s["bytes_out"] for s in stages),
                "spill_bytes": sum(s["spill_bytes"] for s in stages),
            },
            "devtime": {k: round(v, 6) for k, v in dev.items()},
            "overlap": {
                "windows": OVERLAP_WINDOWS,
                "stall_fraction": frac(dev.get("codec_wait", 0.0)),
                "peak_bytes": sto.overlap_peak_bytes,
            },
            "io": io,
            "store": {
                "budget": sto.budget,
                "spill_count": sto.spill_count,
                "spilled_bytes": sto.spilled_bytes,
                "merge_gens": sto.merge_gens,
                "merge_gen_bytes": sto.merge_gen_bytes,
                "h2d_bytes": sto.h2d_bytes,
                "d2h_bytes": sto.d2h_bytes,
                "hbm_offloads": sto.hbm_offloads,
                "hbm_peak_bytes": sto.hbm_peak_bytes,
                "overlap_peak_bytes": sto.overlap_peak_bytes,
            },
            # one device: nothing folds or moves across devices (the
            # device folds on the card are device.mesh_folds)
            "mesh": {"devices": 1, "folds": 0, "exchanges": 0,
                     "exchange_bytes": 0,
                     "exchange": {"bytes": 0, "steps": 0,
                                  "peak_inflight_bytes": 0,
                                  "mesh_stages": 0}},
            "device": device,
            "streamed_assoc_folds": self.streamed_assoc_folds,
            "pipeline": self._pipeline_section(),
            "retries": self.retries_total,
            # retries at every layer (job re-executions and the I/O
            # layer's in-place ones), quarantine, and the injections of
            # an active fault plan
            "faults": self._faults_section(),
            "plan": self.plan_report or plan.empty_report(self.graph),
            "trace_file": None,
            "stats_file": None,
            # the port's own: host seconds in map-side combine folds
            # summed over jobs, spill totals, reduce partitions out of
            # core by path, scan-shared groups, tiny folds
            "combine_seconds": dstate["combine_seconds"],
            "spill": {"count": sto.spill_count,
                      "bytes": sto.spilled_bytes,
                      "merge_gens": sto.merge_gens,
                      "merge_gen_bytes": sto.merge_gen_bytes},
            "streamed_views": self.streamed_views,
            "streamed_joins": self.streamed_joins,
            "scan_sharing": {"groups": [dict(g) for g in
                                        self.scan_groups]},
            "tiny_folds": self.tiny_folds,
        }
        if self.profile_trace_file:
            summary["profile_trace_file"] = self.profile_trace_file
        if self.metrics is not None:
            summary["metrics"] = self.metrics.summary()
        if self.profiler is not None:
            summary["profile"] = self.profiler.summary(
                {s.stage_id: s.seconds for s in self.stats})
        if self.flightrec is not None and self.flightrec.path:
            summary["crashdump_file"] = self.flightrec.path
        if self.logstream is not None:
            if not self._run_failed:
                self.logstream.emit(
                    "info", "run-finish",
                    "run {} finished in {:.3f}s".format(self.name, wall),
                    data={"wall_seconds": round(wall, 3)})
            summary["log"] = self.logstream.summary()
        if self.tracer is not None:
            summary["spans"] = self.tracer.span_summary()
            try:
                from .obs import critpath as _critpath

                summary["critpath"] = _critpath.analyze(
                    summary, self.tracer.events)
            except Exception:
                log.warning("critical-path analysis failed", exc_info=True)
            tdir = _export.run_trace_dir(self.name)
            os.makedirs(tdir, exist_ok=True)
            summary["trace_file"] = _export.write_trace(
                self.tracer, os.path.join(tdir, _export.TRACE_FILE),
                metrics=self.metrics)
            spath = os.path.join(tdir, _export.STATS_FILE)
            summary["stats_file"] = spath
            _export.write_stats(summary, spath)
            log.info("trace: %s; stats: %s", summary["trace_file"], spath)
        self.run_summary = summary
        if not self._run_failed:
            # one record per finalized run (a failed run's measurements
            # would mislead the next run's sizing)
            from .obs import history as _history

            _history.append(summary)
