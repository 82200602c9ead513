"""Background spill writer pool: the codec and the disk off the job's
thread.

Port of ``dampr_tpu/io/writer.py``.  Victims queue onto a small writer
pool and the registering thread returns at once, unless the queue is
full: the bytes queued and not yet written are capped, and are charged
against the stage's memory budget until they land (their RAM is still
held).

Durability and publish order, per write::

    <final>.tmp  ->  write frames  ->  flush + fsync  ->  rename(final)
    ->  ref.path = final; ref._block = None   (under the store lock)

The ref stays readable through its RAM block until the rename has landed,
so a concurrent reader never sees a half-written file.  A failed run's
``abort()`` discards queued writes, releases their charges and leaves no
``.tmp`` file: a queued write that never started never touched the disk.
"""

import logging
import os
import queue
import threading
import time

from .. import faults as _faults
from ..obs import log as _obslog
from ..obs import trace as _trace
from . import frames

log = logging.getLogger("dampr_tpu_torch.io.writer")

_STOP = object()


class SpillWriterPool(object):
    """Bounded writer pool owned by one :class:`~dampr_tpu_torch.storage.
    RunStore`.  Its threads start on the first submit and are daemons."""

    def __init__(self, store, threads, cap_bytes, window):
        self.store = store
        self.n_threads = max(1, threads)
        self.cap_bytes = max(1, cap_bytes)
        self.window = window
        self._q = queue.Queue()
        self._cv = threading.Condition()
        self._threads = []
        self.inflight_bytes = 0   # read by the victim selector
        self.inflight_peak = 0
        self._outstanding = 0
        self.queue_peak = 0       # deepest backlog seen
        self._error = None
        self._aborting = False

    # -- submit side --------------------------------------------------------
    def _ensure_threads(self):
        with self._cv:
            if self._threads:
                return
            for i in range(self.n_threads):
                t = threading.Thread(
                    target=self._worker, daemon=True,
                    name="dampr-spill-writer-{}".format(i))
                t.start()
                self._threads.append(t)

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def submit(self, ref, block, final_path, codec, clear_block=True):
        """Queue one block's write.  ``block`` is the submitter's snapshot
        of the ref's data (a concurrent delete may clear ``ref._block``).
        ``clear_block=True`` is a spill (the publish frees the RAM copy);
        ``False`` a checkpoint persist (the block stays, only ``ref.path``
        lands).  The charge is the larger of the ref's host bytes and the
        snapshot's: a device ref persisted through the pool carries
        metadata-only ``nbytes`` while its fetched value lane is what sits
        in the queue.

        Blocks only while the bytes in flight already sit at the cap (the
        fold-side ``io_wait``).  Admission is by the current backlog, not
        backlog plus this block, so a block larger than the cap is still
        writable and in-flight bytes peak at the cap plus one block."""
        nbytes = max(1, ref.nbytes, block.nbytes())
        with self._cv:
            self._raise_pending()
            w0 = 0.0
            while (self.inflight_bytes >= self.cap_bytes
                   and not self._aborting):
                if not w0:
                    w0 = time.perf_counter()
                self._cv.wait(0.05)
                self._raise_pending()
            if w0:
                self.store.count_io_wait(time.perf_counter() - w0)
                _trace.complete("io_wait", "writer-backpressure", w0,
                                bytes=nbytes)
            self.inflight_bytes += nbytes
            self.inflight_peak = max(self.inflight_peak, self.inflight_bytes)
            self._outstanding += 1
            self.queue_peak = max(self.queue_peak, self._outstanding)
        self._ensure_threads()
        self._q.put((ref, block, final_path, codec, clear_block, nbytes,
                     _trace.now()))

    # -- worker side --------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            ref, block, final, codec, clear_block, nbytes, t_enq = item
            if self._aborting or ref._dead:
                # dropped while queued (merge planners drop merged runs):
                # a publish would only unlink the file
                self._settle(nbytes)
                continue
            # how long the write sat behind the pool's backlog
            _trace.complete("spill_queue", "queued", t_enq, bytes=nbytes)
            tmp = final + ".tmp"

            def write_once():
                # tmp -> fsync -> rename is idempotent, so a transient
                # failure (an injected ``spill_write`` fault among them)
                # retries in place; the site sits inside the retried body
                _faults.check("spill_write")
                try:
                    with _trace.span("spill", "spill-write", bytes=nbytes,
                                     records=len(block)):
                        with open(tmp, "wb") as f:
                            frames.write_block_frames(
                                block, f, codec, self.window,
                                at_least_one=True)
                            f.flush()
                            os.fsync(f.fileno())
                        os.replace(tmp, final)
                except BaseException:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    raise

            try:
                t0 = time.perf_counter()
                _faults.retry_io(write_once, "spill_write")
                secs = time.perf_counter() - t0
                self.store.publish_spill(ref, final,
                                         os.path.getsize(final), secs,
                                         clear_block=clear_block)
            except BaseException as e:  # disk full, codec bug: fail the run
                with self._cv:
                    if self._error is None:
                        self._error = e
                log.error("background spill write failed: %s", e)
            finally:
                self._settle(nbytes)

    def _settle(self, nbytes):
        with self._cv:
            self.inflight_bytes = max(0, self.inflight_bytes - nbytes)
            self._outstanding -= 1
            self._cv.notify_all()

    # -- lifecycle ----------------------------------------------------------
    def drain(self):
        """Block until every queued write has published; re-raise the
        first write failure (the stage-boundary barrier)."""
        with self._cv:
            while self._outstanding > 0:
                self._cv.wait(0.05)
            self._raise_pending()

    def abort(self):
        """The failed run's drain: queued writes not yet started are
        discarded (their refs keep their RAM blocks and never touched the
        disk); a write already started finishes and publishes.  Charges
        are released and no temp file remains."""
        self._aborting = True
        try:
            with self._cv:
                while self._outstanding > 0:
                    self._cv.wait(0.05)
                self._error = None
        finally:
            self._aborting = False

    def close(self):
        """Abort queued writes, then stop the worker threads."""
        self.abort()
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join(timeout=5.0)
            if t.is_alive():
                _obslog.warn("writer-pool-stuck",
                             "spill writer thread %s did not stop within "
                             "5.0 s; abandoning it (daemon)", t.name,
                             logger=log, thread=t.name)
        self._threads = []
