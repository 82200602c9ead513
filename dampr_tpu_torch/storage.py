"""Out-of-core storage: block refs, the memory budget, the spill tier.

Port of ``dampr_tpu/storage.py``.  Every stage output lives behind a
:class:`BlockRef`; the run's :class:`RunStore` keeps the RAM-resident refs
under ``settings.max_memory_per_stage`` by spilling the oldest unpinned
ones to the run's scratch directory.  A pinned ref (a ``cached()``
stage's output) stays in RAM gzip-compressed (:func:`pack_block`), charged
at its compressed size, and never spills; pinned blocks that alone exceed
the budget raise ``MemoryError``.

The tier order is device, RAM, disk.  A map output that a device fold
reads keeps its integer value lane and hash lanes on the device (the HBM
tier, ``settings.hbm_budget``), and the handoff registers a lowered map's
counts there without a host round trip (:meth:`RunStore.register_device`);
over the device budget the oldest device refs offload to the host, the
first spill step.

Spills ride :mod:`.io`: a block spills as a chunked-frame file (one
independently compressed frame per ``SPILL_WINDOW`` records, an index
footer; the JAX package's format, byte for byte) through a background
writer pool whose bytes in flight count against the budget, and reads
back window by window through a prefetching frame reader.  A merge
generation of sorted runs streams file to file (:meth:`RunStore.
register_stream`).  Readers sniff the magic: the pre-frame formats (a
pickle-window stream, gzip'd or plain: a persisted ``cached()`` block, a
checkpoint an older engine wrote) still load.

Every ref a thread registers inside :meth:`RunStore.attempt` is dropped
if the attempt raises, so a retried job never orphans blocks, device
lanes or HBM charge; :meth:`RunStore.release_ref` keeps a checkpointed
ref's file and frees its RAM and device residency.
"""

import contextlib
import gzip
import io as _io
import os
import pickle
import shutil
import threading
import time
import uuid

import numpy as np

from . import faults as _faults
from . import settings
from .io import codecs as _codecs
from .io import frames as _frames
from .io.writer import SpillWriterPool
from .obs import metrics as _metrics
from .obs import trace as _trace
from .ops import devtime


def _file_size(path):
    try:
        return os.path.getsize(path)
    except OSError:
        return 0


class BlockRef(object):
    """A handle to one materialized block: device-resident (its value and
    hash lanes on the card, the HBM tier), RAM-resident, or spilled.  Its
    dtypes survive spilling (they steer the codec and the merge paths).

    A device-resident ref keeps its value lane (int64) and both hash lanes
    (int32 bit patterns) on the run's device, and its keys and hash lanes
    on the host as well (``host_meta``: partition routing and the fold's
    exact-key table), so a fold on the device reads the values without a
    copy either way.  ``lane_abs``/``lane_min`` are the exactness numbers
    the fold's overflow accounting needs, taken where the values were last
    on the host (or summed on the device at the handoff's finalize)."""

    __slots__ = ("_block", "_packed", "path", "nbytes", "nrecords",
                 "value_dtype", "key_dtype", "store", "pin", "_dead", "_dev",
                 "_kmeta", "dev_bytes", "lane_abs", "lane_min",
                 "_h2d_pending", "_ready")

    def __init__(self, block, store=None, pin=False, device_prep=None):
        self._dead = False
        self._packed = None
        self.path = None
        self.nrecords = len(block)
        self.value_dtype = block.values.dtype
        self.key_dtype = block.keys.dtype
        self.store = store
        self.pin = pin
        self._dev = None
        self._kmeta = None
        self.dev_bytes = 0
        self.lane_abs = None
        self.lane_min = None
        self._h2d_pending = 0
        self._ready = None
        if pin:
            # cached(): compressed in RAM, charged at its compressed size,
            # never spilled, inflated per read
            self._block = None
            self._packed = pack_block(block)
            self.nbytes = len(self._packed)
        elif device_prep is not None:
            self._put_device(block, device_prep)
        else:
            self._block = block
            self.nbytes = block.nbytes()

    # -- the HBM tier --------------------------------------------------------
    @staticmethod
    def lane_prep(values):
        """None (the lane stays on the host) or ``(lane, lane_abs,
        lane_min)``: the int64 device lane of an integer or bool value
        lane, a float64 over-estimate of its absolute sum and its minimum.
        It mirrors the fold's lane whitelist
        (``parallel.shuffle._lane_safe_values``), so a device ref never
        meets a refusal at reduce time.  The reference's int32 branch (JAX
        without x64) has no counterpart: torch lanes are int64.  Floats stay
        on the host, as the port's float folds do (a device sum has no
        fixed order); so do uint64 lanes."""
        dt = values.dtype
        if values.ndim != 1 or not (dt == np.bool_ or dt.kind in "iu") \
                or dt == np.uint64:
            return None
        v64 = values.astype(np.int64)
        if not len(v64):
            return v64, 0.0, 0
        # a float64 abs-sum: np.abs over int64 could wrap at int64's min
        return v64, float(np.abs(v64.astype(np.float64)).sum()), \
            int(v64.min())

    def _put_device(self, block, prep):
        """The value lane (cast by :meth:`lane_prep`) and hash lanes onto
        the run's device; keys and hash lanes stay on the host as routing
        metadata.  The copies are synchronous, so any stream may read the
        lanes once this returns."""
        import torch

        dev = settings.resolve_device()
        h1, h2 = block.hashes()
        lane, self.lane_abs, self.lane_min = prep
        nbytes = lane.nbytes + h1.nbytes + h2.nbytes
        with devtime.track("transfer"), _trace.span("hbm", "h2d",
                                                    bytes=int(nbytes)):
            self._dev = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (lane, h1.view(np.int32), h2.view(np.int32)))
        self.dev_bytes = nbytes
        # h2d is charged once, when the store enters the ref
        self._h2d_pending = self.dev_bytes
        self._kmeta = (block.keys, h1, h2)
        self._block = None
        self.nbytes = _meta_bytes(block.keys, h1, h2)

    @classmethod
    def from_device_lanes(cls, keys, h1, h2, dev_vals, dev_h1, dev_h2,
                          store=None, value_dtype=None, lane_abs=None,
                          lane_min=None, h2d_bytes=0, ready=None):
        """A device-resident ref over lanes already on the device (the
        handoff): a lowered map's counts become the fold's input without
        leaving the card.  ``keys``/``h1``/``h2`` are the host routing
        metadata; ``value_dtype`` is what ``get()`` materializes on the
        host; ``h2d_bytes`` charges only what was uploaded to build the ref
        (the hash lanes), never the value lane; ``ready`` is a CUDA event
        recorded after the lanes were made on their stream."""
        ref = cls.__new__(cls)
        ref._dead = False
        ref._packed = None
        ref.path = None
        ref.nrecords = len(keys)
        ref.value_dtype = (np.dtype(value_dtype) if value_dtype is not None
                           else np.dtype(np.int64))
        ref.key_dtype = keys.dtype
        ref.store = store
        ref.pin = False
        ref._dev = (dev_vals, dev_h1, dev_h2)
        ref._kmeta = (keys, h1, h2)
        ref._block = None
        ref.dev_bytes = sum(t.numel() * t.element_size() for t in ref._dev)
        ref._h2d_pending = int(h2d_bytes)
        ref._ready = ready
        ref.lane_abs = lane_abs
        ref.lane_min = lane_min
        ref.nbytes = _meta_bytes(keys, h1, h2)
        return ref

    @property
    def is_device(self):
        return self._dev is not None

    @staticmethod
    def _for_current_stream(dev, ready):
        """Make ``dev``'s lanes safe to read on this thread's current
        stream: it waits for ``ready``, and the caching allocator keeps the
        lanes' memory until the stream's queued work is done."""
        if dev is None or dev[0].device.type != "cuda":
            return dev
        import torch

        stream = torch.cuda.current_stream(dev[0].device)
        if ready is not None:
            stream.wait_event(ready)
        for t in dev:
            t.record_stream(stream)
        return dev

    def device_lanes(self):
        """``(values int64, h1, h2)`` tensors on the device (hash lanes as
        int32 bit patterns): the fold's input, readable on the caller's
        current stream."""
        return self._for_current_stream(self._dev, self._ready)

    def host_meta(self):
        """``(keys, h1, h2)`` host arrays."""
        return self._kmeta

    def offload(self):
        """Device -> host, the HBM tier's spill step.  Returns
        ``(freed_device_bytes, host_bytes_delta)``.  The host block is
        published before the device lanes go, as ``spill()`` publishes its
        path before it drops the block: a concurrent reader past the
        device check uses its own snapshot (``get``)."""
        if self._dev is None:  # raced with a concurrent drop
            return 0, 0
        blk = self.get()  # one counted fetch of the value lane
        freed = self.dev_bytes
        old_host = self.nbytes
        self._block = blk
        self.nbytes = blk.nbytes()
        self._dev = None
        self._kmeta = None
        self._ready = None
        self.dev_bytes = 0
        return freed, self.nbytes - old_host

    @classmethod
    def from_disk(cls, path, nrecords, nbytes, key_dtype, value_dtype):
        """A disk-backed ref with no RAM residency: reads stream from
        ``path``."""
        ref = cls.__new__(cls)
        ref._block = None
        ref._packed = None
        ref._dead = False
        ref.path = path
        ref.nrecords = nrecords
        ref.nbytes = nbytes
        ref.key_dtype = np.dtype(key_dtype)
        ref.value_dtype = np.dtype(value_dtype)
        ref.store = None
        ref.pin = False
        ref._dev = None
        ref._kmeta = None
        ref.dev_bytes = 0
        ref.lane_abs = None
        ref.lane_min = None
        ref._h2d_pending = 0
        ref._ready = None
        return ref

    def __len__(self):
        return self.nrecords

    @property
    def total_bytes(self):
        """Host plus device bytes."""
        return self.nbytes + self.dev_bytes

    @property
    def resident(self):
        return self._block is not None

    def get(self):
        blk = self._block
        if blk is not None:
            return blk
        # Snapshot the lanes and metadata: a concurrent offload() publishes
        # _block first and then clears them, so a reader past this check
        # must not read those slots again.
        dev, kmeta, ready = self._dev, self._kmeta, self._ready
        if dev is not None and kmeta is not None:
            from .blocks import Block

            with devtime.track("transfer"):
                lane = self._for_current_stream(dev, ready)[0].cpu().numpy()
            if self.store is not None:
                self.store.count_d2h(lane.nbytes)
            keys, h1, h2 = kmeta
            return Block(keys, lane.astype(self.value_dtype, copy=False),
                         h1, h2)
        blk = self._block  # an offload may have just published it
        if blk is not None:
            return blk
        if self._packed is not None:
            return unpack_block(self._packed)
        # A publish lands ``path`` before it clears ``_block``, so a ref
        # without its block has its file.  Not re-cached: reduce jobs
        # stream partitions one at a time.
        return load_block(self.path, self.store)

    def iter_windows(self):
        """The block in bounded windows, never materialized whole (a
        resident block yields array-view slices)."""
        blk = self._block
        if blk is None and self._packed is not None:
            blk = unpack_block(self._packed)
        if blk is None:
            if self._dev is not None or self.path is None:
                # device-resident, or an offload racing this read (the
                # path exists only once spilled): get() reads the live tier
                blk = self.get()
            else:
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
            blk = self._block

            def write_once():
                # the writer pool's fault site and transient retry ("wb"
                # truncates, so a retried partial write is idempotent)
                _faults.check("spill_write")
                save_block(blk, path)

            _faults.retry_io(write_once, "spill_write")
            secs = time.perf_counter() - t0
            self.path = path
            # the same bandwidth counters as the writer pool, so the two
            # paths' MB/s compare
            if self.store is not None:
                self.store.count_spill_write(_file_size(path), secs)
        # else: already on disk (a checkpoint persisted it): dropping the
        # RAM copy is the whole spill
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
        self._packed = None
        self._dev = None
        self._kmeta = None
        self._ready = None
        self.dev_bytes = 0
        if self.path and os.path.exists(self.path):
            os.unlink(self.path)
        self.path = None


def _meta_bytes(keys, h1, h2):
    """Host bytes of a device ref's metadata, object keys at the 64 bytes
    a record ``Block.nbytes`` charges."""
    from .blocks import is_numeric

    kb = keys.nbytes if is_numeric(keys) else len(keys) * 64
    return kb + h1.nbytes + h2.nbytes


#: Least records of a reduce-feeding block worth the HBM tier's put (a
#: smaller one stays on the host); a handoff edge's blocks take any size.
HBM_MIN_RECORDS = 4096


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


def _iter_legacy_windows(path, magic):
    """The pre-frame formats: a pickle-window stream, whole-file gzip'd
    for object-lane blocks (sniffed).  A persisted ``cached()`` block is
    one such gzip'd window (:func:`pack_block`'s bytes)."""
    from .blocks import Block

    with open(path, "rb") as raw:
        f = gzip.GzipFile(fileobj=raw) if magic[:2] == b"\x1f\x8b" else raw
        while True:
            try:
                window = pickle.load(f)
            except EOFError:
                return
            except (OSError, pickle.UnpicklingError, ValueError,
                    TypeError, AttributeError, ImportError) as e:
                raise _frames.FrameFormatError(
                    "{}: not a frame file, nor a pre-frame window stream "
                    "({})".format(path, e))
            if not (isinstance(window, tuple) and len(window) == 4
                    and isinstance(window[0], np.ndarray)
                    and isinstance(window[1], np.ndarray)):
                raise _frames.FrameFormatError(
                    "{}: not a frame file, nor a pre-frame window "
                    "stream".format(path))
            yield Block(*window)


def iter_block_windows(path, store=None, prefetch=SPILL_READ_PREFETCH):
    """A spilled block streamed back window by window, with ``prefetch``
    frames in flight on the shared read executor (0 = serial reads).
    ``store`` (when given) accrues the read bandwidth and the read-side
    ``io_wait``.  A file without the frame magic reads through the
    legacy pickle-stream reader, serially."""
    from .blocks import Block

    with open(path, "rb") as f:
        magic = f.read(4)
    if not _frames.is_frame_file(magic):
        for w in _iter_legacy_windows(path, magic):
            yield w
        return

    on_read = on_wait = None
    if store is not None:
        on_read = store.count_spill_read

        def on_wait(secs):
            store.count_io_wait(secs, read=True)
            if _trace.enabled():
                _trace.complete("io_wait", "read-wait",
                                time.perf_counter() - secs)

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


def pack_block(block):
    """A block compressed into RAM bytes (the ``cached()`` tier): one
    gzip'd pickle window, the legacy spill format, so a persisted pinned
    ref reads back through :func:`iter_block_windows`."""
    buf = _io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb",
                       compresslevel=COMPRESS_LEVEL) as f:
        pickle.dump((block.keys, block.values, block.h1, block.h2), f,
                    protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def unpack_block(data):
    from .blocks import Block

    with gzip.GzipFile(fileobj=_io.BytesIO(data), mode="rb") as f:
        keys, values, h1, h2 = pickle.load(f)
    return Block(keys, values, h1, h2)


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
        # per-thread stacks of the refs each open attempt() registered
        self._attempts = threading.local()
        self._resident = []  # RAM refs in registration order (spill order)
        self._resident_bytes = 0
        self._dev_resident = []  # device refs in registration order
        self._dev_bytes = 0
        self._stage = "stage_0"
        self.spill_count = 0
        self.spilled_bytes = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        # the HBM tier: offloads to host and the most device bytes held
        self.hbm_offloads = 0
        self.hbm_peak_bytes = 0
        # the handoff: set by the plan when it marked a device edge; the
        # device bytes registered with no host round trip, the drain bytes
        # table batches never fetched, and the degrades to the spill path
        self.handoff_active = False
        self.handoff_bytes = 0
        self.d2h_avoided_bytes = 0
        self.handoff_degrades = 0
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
        self._closed_peaks = (0, 0)  # (in-flight bytes, queue) of stopped pools
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

    def count_d2h_avoided(self, n):
        """Drain bytes a handoff table batch kept on the device that the
        classic path would have fetched."""
        with self._lock:
            self.d2h_avoided_bytes += int(n)

    def count_handoff_degrade(self):
        with self._lock:
            self.handoff_degrades += 1

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
        now = 0 if w is None else w.inflight_peak
        return max(now, self._closed_peaks[0])

    @property
    def spill_queue_peak(self):
        w = self._writer
        now = 0 if w is None else w.queue_peak
        return max(now, self._closed_peaks[1])

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

    def publish_spill(self, ref, path, disk_bytes, secs, clear_block=True):
        """A background write landed (fsync and rename done): publish
        ``path``, then free the RAM copy, in that order, so a reader past
        the residency check never loses both tiers.  The spill itself was
        counted when it was decided (:meth:`_spill_victims`).
        ``clear_block=False`` (a checkpoint persist) keeps the block."""
        unlink = False
        with self._lock:
            if ref._dead:
                unlink = True
            else:
                ref.path = path
                if clear_block:
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
            victims, evicted_dev = self._select_victims_locked()
        self._spill_victims(victims, evicted_dev)

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
            # the run's peaks outlive its pool (the summary reads them
            # after the pool stops)
            self._closed_peaks = (max(self._closed_peaks[0], w.inflight_peak),
                                  max(self._closed_peaks[1], w.queue_peak))

    # -- registration ------------------------------------------------------------
    @contextlib.contextmanager
    def attempt(self):
        """Track every ref this thread registers inside the block; on an
        exception they are dropped (their files unlinked, their device
        lanes freed and the HBM charge released), so a retried job's
        failed attempt orphans nothing.  Attempts nest: a committed inner
        attempt hands its refs to the enclosing one, whose rollback then
        covers them too."""
        stack = getattr(self._attempts, "stack", None)
        if stack is None:
            stack = self._attempts.stack = []
        refs = []
        stack.append(refs)
        try:
            yield refs
        except BaseException:
            stack.pop()
            for ref in refs:
                self.drop_ref(ref)
            raise
        else:
            stack.pop()
            if stack:
                stack[-1].extend(refs)

    def _note_attempt(self, ref):
        stack = getattr(self._attempts, "stack", None)
        if stack:
            stack[-1].append(ref)

    def set_stage(self, stage_name):
        self._stage = "stage_{}".format(stage_name)

    def hbm_budget(self):
        """The device bytes this run may hold: the handoff's budget once
        the plan marked a device edge (on the CPU legs the plain HBM budget
        is 0 and would offload at once what the handoff keeps), else the
        HBM tier's."""
        if self.handoff_active:
            return settings.effective_handoff_budget()
        return settings.effective_hbm_budget()

    def register(self, block, pin=False, device=False, handoff=False):
        """A ref to ``block``; over budget, the oldest unpinned refs spill.
        ``pin=True`` (a ``cached()`` stage's output) keeps this one in RAM
        for its life.  ``device=True`` (a map output a device fold reads)
        puts an integer value lane on the device under the HBM budget when
        the block holds at least :data:`HBM_MIN_RECORDS` records, or any
        number on a handoff edge (``handoff=True``).  Such a block came
        through the host, so it never counts in ``handoff_bytes``."""
        prep = None
        floor = 1 if handoff else HBM_MIN_RECORDS
        if (device and not pin and settings.use_device
                and self.hbm_budget() > 0 and len(block) >= floor):
            prep = BlockRef.lane_prep(block.values)
        return self._enter_ref(BlockRef(block, store=self, pin=pin,
                                        device_prep=prep))

    def register_device(self, ref):
        """Enter a ref built on the device
        (:meth:`BlockRef.from_device_lanes`, the handoff) under the same
        budgets; only its pending hash-lane upload charges h2d."""
        ref.store = self
        return self._enter_ref(ref, handoff=True)

    def _enter_ref(self, ref, handoff=False):
        if _metrics.enabled():
            # stage-output throughput: every materialized block enters here
            _metrics.counter_add("store.records", len(ref))
            _metrics.counter_add("store.bytes", ref.nbytes + ref.dev_bytes)
            _metrics.counter_add("store.blocks", 1)
        self._note_attempt(ref)
        dev_victims = []
        with self._lock:
            if ref.is_device:
                self._dev_resident.append(ref)
                self._dev_bytes += ref.dev_bytes
                # h2d per transfer, from the ref's pending charge: a ref
                # entered again adds nothing
                self.h2d_bytes += ref._h2d_pending
                ref._h2d_pending = 0
                if handoff:
                    self.handoff_bytes += ref.dev_bytes
                self.hbm_peak_bytes = max(self.hbm_peak_bytes,
                                          self._dev_bytes)
                dev_victims = self._select_dev_victims_locked()
            # the host budget charges what stays on the host: the block,
            # or a device ref's keys and hash lanes
            self._resident.append(ref)
            self._resident_bytes += ref.nbytes
            victims, evicted_dev = self._select_victims_locked()
        # offloads and spill I/O run outside the lock: victims already left
        # their resident lists, so each is selected once
        for v in dev_victims:
            self._offload_ref(v)
        self._spill_victims(victims, evicted_dev)
        return ref

    def release_device(self):
        """Drop every device-resident ref and return the device budget to
        0: the failed run's path.  Its lanes will never be read, so they
        go outright (no offload copy).  A ref a checkpoint persisted keeps
        its file (the manifest a resumed run restores from names it)."""
        with self._lock:
            victims = list(self._dev_resident)
            self._dev_resident = []
            self._dev_bytes = 0
            for ref in victims:
                if ref in self._resident:
                    self._resident.remove(ref)
                    self._resident_bytes -= ref.nbytes
        for ref in victims:
            if ref.path is not None:
                ref._dev = ref._kmeta = ref._ready = None
                ref.dev_bytes = 0
            else:
                ref.delete()

    def _select_dev_victims_locked(self):
        """The oldest device refs past the HBM budget, to offload to the
        host (whose pressure then cascades to disk).  They leave both
        resident lists here, so no later selection picks them twice;
        :meth:`_offload_ref` enters them again as host refs."""
        budget = self.hbm_budget()
        if self._dev_bytes <= budget:
            return []
        victims = []
        keep = []
        for ref in self._dev_resident:
            if self._dev_bytes > budget and ref.is_device:
                victims.append(ref)
                self._dev_bytes -= ref.dev_bytes
                if ref in self._resident:
                    self._resident.remove(ref)
                    self._resident_bytes -= ref.nbytes
            else:
                keep.append(ref)
        self._dev_resident = keep
        return victims

    def _offload_ref(self, ref):
        """Device -> host for one ref already out of both resident lists
        (outside the lock), then enter it again as a host ref, which may
        spill."""
        with _trace.span("hbm", "offload", bytes=ref.dev_bytes):
            freed, _delta = ref.offload()
        if not freed:
            return  # raced with a concurrent drop
        with self._lock:
            self.hbm_offloads += 1
            self._resident.append(ref)
            self._resident_bytes += ref.nbytes
            victims, evicted_dev = self._select_victims_locked()
        self._spill_victims(victims, evicted_dev)

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
        t0 = _trace.now()
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
        self._note_attempt(ref)
        if fw is None:
            ref._block = Block.empty()  # empty stream: nothing on disk
        else:
            self.count_spill_write(_file_size(path), write_secs)
        if _metrics.enabled():
            _metrics.counter_add("store.records", total_records)
            _metrics.counter_add("store.bytes", total_bytes)
            _metrics.counter_add("store.blocks", 1)
        with self._lock:
            self.merge_gens += 1
            self.merge_gen_bytes += total_bytes
        _trace.complete("merge", "merge-run", t0, bytes=total_bytes,
                        records=total_records)
        return ref

    def _select_victims_locked(self):
        """The oldest unpinned refs until residency meets the budget; their
        bytes come off at once, so other threads see the budget relieved.
        Bytes queued in the writer pool (their RAM is still held) shrink
        the target, and so do the overlap executor's blocks in flight.
        Pinned refs stay (compressed, :func:`pack_block`); when they alone
        exceed the budget this raises ``MemoryError`` rather than grow
        without bound.  Returns ``(victims, evicted_dev)``: a device ref's
        host metadata cannot spill in place, so under host pressure it is
        evicted whole (offload, then disk) and leaves both accountings
        here."""
        inflight = 0 if self._writer is None else self._writer.inflight_bytes
        target = max(0, self.budget - self._overlap_bytes - inflight)
        if self._resident_bytes <= target:
            return [], []
        victims = []
        evicted_dev = []
        keep = []
        for ref in self._resident:
            if self._resident_bytes <= target or ref.pin:
                keep.append(ref)
            elif ref.resident:
                victims.append(ref)
                self._resident_bytes -= ref.nbytes
            elif ref.is_device:
                evicted_dev.append(ref)
                self._resident_bytes -= ref.nbytes
                if ref in self._dev_resident:
                    self._dev_resident.remove(ref)
                    self._dev_bytes -= ref.dev_bytes
            else:
                keep.append(ref)
        self._resident = keep
        if self._resident_bytes > self.budget:
            # what remains is cached() data, already compressed
            raise MemoryError(
                "cached() blocks exceed the memory budget even compressed "
                "({} > {} bytes); raise the budget or drop a cached()/"
                "memory=True stage".format(
                    self._resident_bytes, self.budget))
        return victims, evicted_dev

    def _spill_victims(self, victims, evicted_dev=()):
        """Spill I/O for selected victims, outside the lock.  With the
        writer pool on, each victim queues and this thread returns; its RAM
        stays readable (and charged, as bytes in flight) until the write
        publishes.

        A spill counts when it is decided: the victim left the resident
        set here, whether or not its queued write later lands for a live
        ref (a merge generation may drop the ref first), so the counts do
        not depend on how fast the writer threads run.

        ``evicted_dev`` refs (device refs under host pressure) offload
        first, on this thread, and then take the same write path."""
        if not victims and not evicted_dev:
            return
        directory = os.path.join(self.root, self._stage)
        offloaded = []
        for v in evicted_dev:
            with _trace.span("hbm", "offload", bytes=v.dev_bytes):
                if v.offload()[0]:
                    offloaded.append(v)
        evicted_dev = offloaded
        if evicted_dev:
            with self._lock:
                self.hbm_offloads += len(evicted_dev)
        pool = self.writer_pool()
        freed = n_spilled = 0
        queued = []
        for v in list(evicted_dev) + list(victims):
            if pool is not None and v.path is None and v._block is not None:
                queued.append(v)
            else:
                with _trace.span("spill", "spill", bytes=v.nbytes,
                                 records=len(v)):
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
            if ref in self._dev_resident:
                self._dev_resident.remove(ref)
                self._dev_bytes -= ref.dev_bytes
        ref.delete()

    def release_ref(self, ref):
        """Free a checkpointed ref's residency but keep its file: the
        budgets no longer charge it and reads stream from disk.  A ref
        with no file keeps its RAM block (nothing else holds the data);
        one with a file also gives its device lanes back (the durable copy
        is on disk)."""
        with self._lock:
            if ref in self._resident:
                self._resident.remove(ref)
                self._resident_bytes -= ref.nbytes
            if ref.path is not None and ref in self._dev_resident:
                self._dev_resident.remove(ref)
                self._dev_bytes -= ref.dev_bytes
        if ref.path is not None:
            ref._block = None
            ref._dev = None
            ref._kmeta = None
            ref._ready = None
            ref.dev_bytes = 0

    def cleanup(self):
        """Stop the writer pool and remove the run's scratch tree."""
        self.stop_writes()
        if os.path.isdir(self.root):
            shutil.rmtree(self.root, ignore_errors=True)


class PartitionSet(object):
    """A stage output: per-partition lists of BlockRefs.

    Provenance flags, what downstream fast paths may assume (the
    identity-checkpoint alias and resume read them):

    ``hash_routed``: every record lives in partition ``h1 % P`` (map
    outputs routed through ``split_by_partition``; a reduce's output is
    registered under its job's pid whatever keys the reducer emitted, so
    it is not).
    ``hash_sorted``: every ref is an (h1, h2)-sorted run, the invariant
    the over-budget streaming merge relies on.
    ``key_sorted_runs``: every ref is a KEY-sorted run of numeric keys
    registered without partition fan-out (sorted-run mode); the final read
    streams a k-way merge over the runs instead of re-sorting.
    ``pipeline_fold_delta``: per pid, the bytes a streamed edge's early
    folds took off the staged output (the reduce's size gate adds them
    back).
    """

    def __init__(self, n_partitions, hash_routed=False, hash_sorted=False,
                 key_sorted_runs=False):
        self.n_partitions = n_partitions
        self.parts = {}
        self.hash_routed = hash_routed
        self.hash_sorted = hash_sorted
        self.key_sorted_runs = key_sorted_runs
        self.pipeline_fold_delta = {}

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

    def release(self, store):
        """Free residency, keep the files (checkpoint retention)."""
        for ref in list(self.all_refs()):
            store.release_ref(ref)
