"""Out-of-core storage: block refs, the memory budget, the spill tier.

Port of the host tiers of ``dampr_tpu/storage.py``.  Every stage output
lives behind a :class:`BlockRef`; the run's :class:`RunStore` keeps the
RAM-resident refs under ``settings.max_memory_per_stage`` by spilling the
oldest unpinned ones to the run's scratch directory.  A pinned ref (a
``cached()`` stage's output) stays in RAM, whole.

Spills ride :mod:`.io`: a block spills as a chunked-frame file (one
independently compressed frame per ``SPILL_WINDOW`` records, an index
footer; the JAX package's format, byte for byte) through a background
writer pool whose bytes in flight count against the budget, and reads
back window by window through a prefetching frame reader.  A merge
generation of sorted runs streams file to file (:meth:`RunStore.
register_stream`).  Every file the port reads is a frame file: anything
else raises :class:`~.io.frames.FrameFormatError`.
"""

import os
import shutil
import threading
import time
import uuid

import numpy as np

from . import settings
from .io import codecs as _codecs
from .io import frames as _frames
from .io.writer import SpillWriterPool


def _file_size(path):
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


class BlockRef(object):
    """A handle to one materialized block, RAM-resident or spilled.  Its
    dtypes survive spilling (they steer the codec and the merge paths)."""

    __slots__ = ("_block", "path", "nbytes", "nrecords", "value_dtype",
                 "key_dtype", "store", "pin", "_dead")

    def __init__(self, block, store=None, pin=False):
        self._block = block
        self._dead = False
        self.path = None
        self.nbytes = block.nbytes()
        self.nrecords = len(block)
        self.value_dtype = block.values.dtype
        self.key_dtype = block.keys.dtype
        self.store = store
        self.pin = pin

    @classmethod
    def from_disk(cls, path, nrecords, nbytes, key_dtype, value_dtype):
        """A disk-backed ref with no RAM residency: reads stream from
        ``path``."""
        ref = cls.__new__(cls)
        ref._block = None
        ref._dead = False
        ref.path = path
        ref.nrecords = nrecords
        ref.nbytes = nbytes
        ref.key_dtype = np.dtype(key_dtype)
        ref.value_dtype = np.dtype(value_dtype)
        ref.store = None
        ref.pin = False
        return ref

    def __len__(self):
        return self.nrecords

    @property
    def resident(self):
        return self._block is not None

    def get(self):
        blk = self._block
        if blk is not None:
            return blk
        # A publish lands ``path`` before it clears ``_block``, so a ref
        # without its block has its file.  Not re-cached: reduce jobs
        # stream partitions one at a time.
        return load_block(self.path, self.store)

    def iter_windows(self):
        """The block in bounded windows, never materialized whole (a
        resident block yields array-view slices)."""
        blk = self._block
        if blk is None:
            for w in iter_block_windows(self.path, self.store):
                yield w
            return
        for at in range(0, len(blk), SPILL_WINDOW):
            yield blk.slice(at, at + SPILL_WINDOW)

    def spill(self, directory):
        """Synchronous spill; returns the RAM bytes freed."""
        if self._block is None or self.pin:
            return 0
        if self.path is None:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, uuid.uuid4().hex + ".blk")
            t0 = time.perf_counter()
            save_block(self._block, path)
            secs = time.perf_counter() - t0
            self.path = path
            # the same bandwidth counters as the writer pool, so the two
            # paths' MB/s compare
            if self.store is not None:
                self.store.count_spill_write(_file_size(path), secs)
        freed = self.nbytes
        self._block = None
        return freed

    def delete(self):
        # Serialized against the writer pool's publish (both take the
        # store lock): either the publish lands first and this unlinks the
        # file, or ``_dead`` lands first and the publish unlinks its own
        # write.  A dropped ref never leaks a spill file.
        store = self.store
        if store is not None:
            with store._lock:
                self._delete_inner()
        else:
            self._delete_inner()

    def _delete_inner(self):
        self._dead = True
        self._block = None
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)
        self.path = None


#: Records per spill window: the unit of streamed re-reads.  A k-way merge
#: holds k windows, never k whole blocks.
SPILL_WINDOW = 16384

#: Codec of blocks with an object lane: the best one importable here
#: (zstd, then lz4, then zlib at :data:`COMPRESS_LEVEL`).
SPILL_CODEC = "auto"
COMPRESS_LEVEL = 1

#: Frames in flight per spilled-block reader on the shared read executor.
SPILL_READ_PREFETCH = 2


def _spill_codec(key_dtype, value_dtype):
    """The compression policy every spill writer shares: all-numeric
    blocks spill raw (high-entropy lanes compress little and cost a
    core-bound pass each way), blocks with an object lane compress with
    :data:`SPILL_CODEC`."""
    if key_dtype != object and value_dtype != object:
        return _codecs.resolve("raw")
    return _codecs.resolve(SPILL_CODEC, COMPRESS_LEVEL)


def save_block(block, path, codec=None):
    """Write ``block`` as a frame file: ``SPILL_WINDOW``-record columnar
    slices, one independently compressed frame each, and the footer.
    ``codec`` (a :class:`~.io.codecs.Codec`) overrides the policy."""
    if codec is None:
        codec = _spill_codec(block.keys.dtype, block.values.dtype)
    with open(path, "wb") as f:
        _frames.write_block_frames(block, f, codec, SPILL_WINDOW,
                                   at_least_one=True)


def iter_block_windows(path, store=None, prefetch=SPILL_READ_PREFETCH):
    """A spilled block streamed back window by window, with ``prefetch``
    frames in flight on the shared read executor (0 = serial reads).
    ``store`` (when given) accrues the read bandwidth and the read-side
    ``io_wait``."""
    from .blocks import Block

    on_read = on_wait = None
    if store is not None:
        on_read = store.count_spill_read

        def on_wait(secs):
            store.count_io_wait(secs, read=True)

    reader = _frames.FrameReader(path)
    payloads = reader.iter_payloads(prefetch, on_read, on_wait)
    try:
        for payload in payloads:
            keys, values, h1, h2 = _frames.load_window_payload(payload)
            yield Block(keys, values, h1, h2)
    finally:
        # the payload generator first: its own finally waits out the
        # reads in flight before the fd goes
        payloads.close()
        reader.close()


def load_block(path, store=None):
    from .blocks import Block

    return Block.concat(list(iter_block_windows(path, store)))


class RunStore(object):
    """Per-run block registry under a byte budget, plus the run's spill
    I/O and host<->device byte counters.  Thread-safe: jobs register
    concurrently.  ``inflight_cap`` caps the writer pool's queued bytes
    (default: half the budget, at least 4 MiB)."""

    def __init__(self, name, budget=None, inflight_cap=None):
        self.budget = (settings.max_memory_per_stage if budget is None
                       else budget)
        self.inflight_cap = (max(self.budget // 2, 1 << 22)
                             if inflight_cap is None else inflight_cap)
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
        self.root = os.path.join(settings.scratch_root, safe)
        self._lock = threading.Lock()
        self._resident = []  # RAM refs in registration order (spill order)
        self._resident_bytes = 0
        self._stage = "stage_0"
        self.spill_count = 0
        self.spilled_bytes = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        #: {op: {"calls", "seconds"}} of the keyed batch ops' device calls
        self.keyed = {}
        # streamed merge generations (register_stream)
        self.merge_gens = 0
        self.merge_gen_bytes = 0
        # spill I/O: bytes on disk and seconds of every write and frame
        # read, and the seconds a job waited on the writer pool's cap or
        # on a frame not yet prefetched (the run summary's ``io``)
        self.spill_disk_bytes = 0
        self.spill_write_seconds = 0.0
        self.spill_read_bytes = 0
        self.spill_read_seconds = 0.0
        self.io_wait_seconds = 0.0
        self.io_wait_write_seconds = 0.0
        self._writer = None
        # blocks a map job's codec has produced and its fold not yet taken
        # (the overlap executor), charged to the budget
        self._overlap_bytes = 0
        self.overlap_peak_bytes = 0

    # -- counters ------------------------------------------------------------
    def count_keyed(self, name, seconds, h2d, d2h):
        """One device call of a keyed batch op (:mod:`.ops.devtime`): its
        host seconds, and its copies into the h2d/d2h counters."""
        with self._lock:
            c = self.keyed.setdefault(name, {"calls": 0, "seconds": 0.0})
            c["calls"] += 1
            c["seconds"] += seconds
            self.h2d_bytes += int(h2d)
            self.d2h_bytes += int(d2h)

    def count_h2d(self, n):
        with self._lock:
            self.h2d_bytes += int(n)

    def count_d2h(self, n):
        with self._lock:
            self.d2h_bytes += int(n)

    def count_spill_read(self, nbytes, secs):
        with self._lock:
            self.spill_read_bytes += nbytes
            self.spill_read_seconds += secs

    def count_spill_write(self, disk_bytes, secs):
        """Every spill writer (synchronous, the pool, merge generations)
        feeds the same bandwidth counters."""
        with self._lock:
            self.spill_disk_bytes += disk_bytes
            self.spill_write_seconds += secs

    def count_io_wait(self, secs, read=False):
        """``read=False``: a registering thread blocked on the writer
        pool's cap; ``read=True``: a reader outran its frame prefetch."""
        with self._lock:
            self.io_wait_seconds += secs
            if not read:
                self.io_wait_write_seconds += secs

    # -- the writer pool -------------------------------------------------------
    @property
    def spill_inflight_bytes(self):
        w = self._writer
        return 0 if w is None else w.inflight_bytes

    @property
    def spill_inflight_peak_bytes(self):
        w = self._writer
        return 0 if w is None else w.inflight_peak

    @property
    def spill_queue_peak(self):
        w = self._writer
        return 0 if w is None else w.queue_peak

    def writer_pool(self):
        """The store's background writer, or None when
        ``settings.spill_write_threads`` is 0 (synchronous spills)."""
        if settings.spill_write_threads <= 0:
            return None
        if self._writer is None:
            with self._lock:
                if self._writer is None:
                    self._writer = SpillWriterPool(
                        self, settings.spill_write_threads,
                        self.inflight_cap, SPILL_WINDOW)
        return self._writer

    def publish_spill(self, ref, path, disk_bytes, secs):
        """A background write landed (fsync and rename done): publish
        ``path``, then free the RAM copy, in that order, so a reader past
        the residency check never loses both tiers.  The spill itself was
        counted when it was decided (:meth:`_spill_victims`)."""
        unlink = False
        with self._lock:
            if ref._dead:
                unlink = True
            else:
                ref.path = path
                ref._block = None
        self.count_spill_write(disk_bytes, secs)
        if unlink:
            try:
                os.unlink(path)
            except OSError:
                pass

    def drain_writes(self):
        """Barrier: every queued spill has published; a failed write
        raises here."""
        if self._writer is not None:
            self._writer.drain()

    # -- the overlap executor's in-flight blocks ------------------------------
    @property
    def overlap_bytes(self):
        return self._overlap_bytes

    def reserve_overlap(self, n):
        """Charge ``n`` bytes of codec output in flight to the budget:
        resident refs spill to make room (victims chosen under the lock,
        spilled outside it), so readahead trades residency instead of
        adding to it."""
        with self._lock:
            self._overlap_bytes += n
            self.overlap_peak_bytes = max(self.overlap_peak_bytes,
                                          self._overlap_bytes)
            victims = self._select_victims_locked()
        self._spill_victims(victims)

    def release_overlap(self, n):
        with self._lock:
            self._overlap_bytes = max(0, self._overlap_bytes - n)

    def abort_writes(self):
        """The failed run's drain: queued writes are discarded (their refs
        keep their RAM blocks), started ones finish; no charge and no
        temp file remains."""
        if self._writer is not None:
            self._writer.abort()

    def stop_writes(self):
        """Stop the writer pool's threads (queued writes are aborted
        first); a later spill starts a new pool."""
        w, self._writer = self._writer, None
        if w is not None:
            w.close()

    # -- registration ------------------------------------------------------------
    def set_stage(self, stage_name):
        self._stage = "stage_{}".format(stage_name)

    def register(self, block, pin=False):
        """A ref to ``block``, RAM-resident; over budget, the oldest
        unpinned refs spill.  ``pin=True`` (a ``cached()`` stage's output)
        keeps this one in RAM for its life."""
        ref = BlockRef(block, store=self, pin=pin)
        with self._lock:
            self._resident.append(ref)
            self._resident_bytes += ref.nbytes
            victims = self._select_victims_locked()
        # the spill I/O runs outside the lock: victims already left the
        # resident list, so each is selected once
        self._spill_victims(victims)
        return ref

    def register_stream(self, blocks):
        """Write an iterator of key-sorted window blocks straight into a
        disk-backed ref: one merge generation.  Data streams file -> merge
        -> file in ``SPILL_WINDOW`` frames and is never RAM- or
        budget-resident whole.  The codec follows the first window's
        dtypes (a merged run is dtype-uniform)."""
        from .blocks import Block

        directory = os.path.join(self.root, self._stage)
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, uuid.uuid4().hex + ".blk")
        raw = fw = None
        total_records = total_bytes = 0
        write_secs = 0.0
        key_dtype = value_dtype = np.dtype(object)
        try:
            for blk in blocks:
                if not len(blk):
                    continue
                if fw is None:
                    key_dtype = blk.keys.dtype
                    value_dtype = blk.values.dtype
                    raw = open(path, "wb")
                    fw = _frames.FrameWriter(
                        raw, _spill_codec(key_dtype, value_dtype))
                w0 = time.perf_counter()
                fw.add_block(blk, SPILL_WINDOW)
                write_secs += time.perf_counter() - w0
                total_records += len(blk)
                total_bytes += blk.nbytes()
            if fw is not None:
                w0 = time.perf_counter()
                fw.close()
                raw.close()
                write_secs += time.perf_counter() - w0
        except BaseException:
            # a failed generation strands no fd and no partial file
            if raw is not None:
                try:
                    raw.close()
                except OSError:
                    pass
                try:
                    os.unlink(path)
                except OSError:
                    pass
            raise
        ref = BlockRef.from_disk(path if fw is not None else None,
                                 total_records, total_bytes,
                                 key_dtype, value_dtype)
        ref.store = self
        if fw is None:
            ref._block = Block.empty()  # empty stream: nothing on disk
        else:
            self.count_spill_write(_file_size(path), write_secs)
        with self._lock:
            self.merge_gens += 1
            self.merge_gen_bytes += total_bytes
        return ref

    def _select_victims_locked(self):
        """The oldest unpinned refs until residency meets the budget; their
        bytes come off at once, so other threads see the budget relieved.
        Bytes queued in the writer pool (their RAM is still held) shrink
        the target, and so do the overlap executor's blocks in flight.
        Pinned refs stay whatever they weigh: the port holds ``cached()``
        blocks whole in RAM."""
        inflight = 0 if self._writer is None else self._writer.inflight_bytes
        target = max(0, self.budget - self._overlap_bytes - inflight)
        if self._resident_bytes <= target:
            return []
        victims = []
        keep = []
        for ref in self._resident:
            if self._resident_bytes <= target or ref.pin:
                keep.append(ref)
            elif ref.resident:
                victims.append(ref)
                self._resident_bytes -= ref.nbytes
            else:
                keep.append(ref)
        self._resident = keep
        return victims

    def _spill_victims(self, victims):
        """Spill I/O for selected victims, outside the lock.  With the
        writer pool on, each victim queues and this thread returns; its RAM
        stays readable (and charged, as bytes in flight) until the write
        publishes.

        A spill counts when it is decided: the victim left the resident
        set here, whether or not its queued write later lands for a live
        ref (a merge generation may drop the ref first), so the counts do
        not depend on how fast the writer threads run."""
        if not victims:
            return
        directory = os.path.join(self.root, self._stage)
        pool = self.writer_pool()
        freed = n_spilled = 0
        queued = []
        for v in victims:
            if pool is not None and v.path is None and v._block is not None:
                queued.append(v)
            else:
                got = v.spill(directory)
                if got:
                    freed += got
                    n_spilled += 1
        if queued:
            os.makedirs(directory, exist_ok=True)
            for v in queued:
                blk = v._block
                if blk is None:  # raced with a concurrent drop
                    continue
                path = os.path.join(directory, uuid.uuid4().hex + ".blk")
                pool.submit(v, blk, path,
                            _spill_codec(v.key_dtype, v.value_dtype))
                freed += v.nbytes
                n_spilled += 1
        if n_spilled:
            with self._lock:
                self.spill_count += n_spilled
                self.spilled_bytes += freed

    def drop_ref(self, ref):
        with self._lock:
            if ref in self._resident:
                self._resident.remove(ref)
                self._resident_bytes -= ref.nbytes
        ref.delete()

    def cleanup(self):
        """Stop the writer pool and remove the run's scratch tree."""
        self.stop_writes()
        if os.path.isdir(self.root):
            shutil.rmtree(self.root, ignore_errors=True)


class PartitionSet(object):
    """A stage output: per-partition lists of BlockRefs.

    ``key_sorted_runs``: every ref is a KEY-sorted run of numeric keys
    registered without partition fan-out (sorted-run mode); the final read
    streams a k-way merge over the runs instead of re-sorting.
    """

    def __init__(self, n_partitions, key_sorted_runs=False):
        self.n_partitions = n_partitions
        self.parts = {}
        self.key_sorted_runs = key_sorted_runs

    def add(self, pid, ref):
        self.parts.setdefault(pid, []).append(ref)

    def refs(self, pid):
        return self.parts.get(pid, [])

    def all_refs(self):
        for pid in sorted(self.parts):
            for ref in self.parts[pid]:
                yield ref

    def total_records(self):
        return sum(len(r) for r in self.all_refs())

    def delete(self, store=None):
        for ref in list(self.all_refs()):
            if store is not None:
                store.drop_ref(ref)
            else:
                ref.delete()
        self.parts = {}
