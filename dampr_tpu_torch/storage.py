"""Out-of-core storage: block refs, the memory budget, synchronous spill.

Port of the :class:`RunStore` subset of ``dampr_tpu/storage.py`` that the
slice needs: block registration, get/delete, byte accounting against the
memory budget, and the synchronous spill/reload path (the reference's
``spill_write_threads=0`` behaviour).  Over budget, the oldest
unpinned RAM-resident blocks pickle to the run's scratch directory and
reload on ``get()``; a spilled file goes with its ref's deletion.  A
pinned block (``cached()``) never spills.  The async writer pool, chunked
spill frames and the HBM tier are later slices.
"""

import os
import pickle
import threading
import uuid

from . import settings


class BlockRef(object):
    """A handle to one materialized block, RAM-resident or spilled."""

    __slots__ = ("_block", "path", "nbytes", "nrecords", "store", "pin")

    def __init__(self, block, store=None, pin=False):
        self._block = block
        self.path = None
        self.nbytes = block.nbytes()
        self.nrecords = len(block)
        self.store = store
        self.pin = pin

    def __len__(self):
        return self.nrecords

    @property
    def resident(self):
        return self._block is not None

    def get(self):
        blk = self._block
        if blk is not None:
            return blk
        with open(self.path, "rb") as f:
            return pickle.load(f)

    def spill(self, directory):
        """Write the block to disk and drop it from RAM (caller holds the
        store lock); returns the bytes freed."""
        path = os.path.join(directory, "blk-{}.pkl".format(uuid.uuid4().hex))
        with open(path, "wb") as f:
            pickle.dump(self._block, f, protocol=pickle.HIGHEST_PROTOCOL)
        self.path = path
        self._block = None
        return self.nbytes

    def delete(self):
        self._block = None
        if self.path is not None:
            try:
                os.unlink(self.path)
            except FileNotFoundError:
                pass
            self.path = None


class RunStore(object):
    """Per-run block registry enforcing the RAM budget by synchronous
    spill, plus the run's host<->device byte counters."""

    def __init__(self, name, budget=None):
        self.budget = (settings.max_memory_per_stage if budget is None
                       else budget)
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in name)
        self.root = os.path.join(settings.scratch_root, safe)
        self._lock = threading.Lock()
        self._resident = []  # RAM refs in registration order (spill order)
        self.ram_bytes = 0
        self.spill_count = 0
        self.spill_bytes = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        #: {op: {"calls", "seconds"}} of the keyed batch ops' device calls
        self.keyed = {}

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

    def register(self, block, pin=False):
        """A ref to ``block``, RAM-resident; over budget, the oldest
        unpinned refs spill.  ``pin=True`` (a ``cached()`` stage's output)
        keeps this one in RAM for its life."""
        ref = BlockRef(block, store=self, pin=pin)
        with self._lock:
            self._resident.append(ref)
            self.ram_bytes += ref.nbytes
            if self.ram_bytes > self.budget:
                self._spill_over_budget()
        return ref

    def _spill_over_budget(self):
        os.makedirs(self.root, exist_ok=True)
        keep = []
        for ref in self._resident:
            if (self.ram_bytes <= self.budget or not ref.resident
                    or ref.pin):
                keep.append(ref)
                continue
            freed = ref.spill(self.root)
            self.ram_bytes -= freed
            self.spill_count += 1
            self.spill_bytes += freed
        self._resident = [r for r in keep if r.resident]

    def drop_ref(self, ref):
        with self._lock:
            if ref.resident:
                self.ram_bytes -= ref.nbytes
                self._resident = [r for r in self._resident if r is not ref]
            ref.delete()


class PartitionSet(object):
    """A stage output: per-partition lists of BlockRefs."""

    def __init__(self, n_partitions):
        self.n_partitions = n_partitions
        self.parts = {}

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
