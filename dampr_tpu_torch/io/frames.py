"""Chunked-frame spill files: independently compressed, length-prefixed
frames with an index footer.

Port of ``dampr_tpu/io/frames.py``; the format is byte-compatible, so a
file either package writes reads back in the other.  Each frame's payload
is one pickled columnar ``(keys, values, h1, h2)`` window.  Frames
compress independently and the footer indexes them, so frames decompress
in parallel, a stream reader prefetches a bounded readahead per run
during a k-way merge, and a reader seeks straight to frame *i*.

Layout (all integers little-endian)::

    header   b"DTFR" | u8 version (1)
    frame*   u8 codec_id | u64 raw_len | u64 comp_len | payload
    footer   pickled {"frames": [(offset, codec_id, raw_len, comp_len,
                                  records), ...], "records": total}
    trailer  u64 footer_offset | b"DTFE"

The trailer magic proves the footer landed: a write cut short fails
loudly with :class:`FrameFormatError`, never as a silently short block.
"""

import os
import pickle
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

from . import codecs

MAGIC = b"DTFR"
TRAILER_MAGIC = b"DTFE"
VERSION = 1

_HEADER = struct.Struct("<4sB")
_FRAME = struct.Struct("<BQQ")
_TRAILER = struct.Struct("<Q4s")


class FrameFormatError(RuntimeError):
    """Corrupt, truncated, or non-frame file where a frame file was
    expected."""


def is_frame_file(magic4):
    return magic4[:4] == MAGIC


class FrameWriter(object):
    """Append frames to an open binary file; ``close()`` writes the index
    footer and the trailer.  One writer per file, one thread."""

    def __init__(self, f, codec):
        self.f = f
        self.codec = codec
        self.index = []
        self.records = 0
        f.write(_HEADER.pack(MAGIC, VERSION))

    def add_frame(self, payload, records=0):
        """Compress and append one frame; returns its compressed size."""
        comp = self.codec.compress(payload)
        off = self.f.tell()
        self.f.write(_FRAME.pack(self.codec.cid, len(payload), len(comp)))
        self.f.write(comp)
        self.index.append((off, self.codec.cid, len(payload), len(comp),
                           records))
        self.records += records
        return len(comp)

    def add_block(self, block, window, at_least_one=False):
        """Append one block as ``window``-record columnar slices: the one
        slicing every spill writer shares."""
        n = len(block)
        for at in range(0, max(n, 1) if at_least_one else n, window):
            w = block.slice(at, at + window)
            self.add_frame(dump_window_payload(w.keys, w.values, w.h1, w.h2),
                           records=len(w))

    def close(self):
        """Write the footer and the trailer.  Flushing, fsyncing and
        closing the file stay with the caller."""
        footer_off = self.f.tell()
        self.f.write(pickle.dumps(
            {"frames": self.index, "records": self.records},
            protocol=pickle.HIGHEST_PROTOCOL))
        self.f.write(_TRAILER.pack(footer_off, TRAILER_MAGIC))


class FrameReader(object):
    """Random-access reader over one frame file.  ``os.pread`` lets
    concurrent prefetch tasks share one fd without seek races."""

    def __init__(self, path):
        self.path = path
        self._fd = os.open(path, os.O_RDONLY)
        self._closed = False
        try:
            size = os.fstat(self._fd).st_size
            head = os.pread(self._fd, _HEADER.size, 0)
            if len(head) < _HEADER.size or head[:4] != MAGIC:
                raise FrameFormatError(
                    "{}: not a frame spill file".format(path))
            version = head[4]
            if version > VERSION:
                raise FrameFormatError(
                    "{}: frame format version {} is newer than this "
                    "reader (max {})".format(path, version, VERSION))
            if size < _HEADER.size + _TRAILER.size:
                raise FrameFormatError(
                    "{}: truncated frame file ({} bytes)".format(path, size))
            trailer = os.pread(self._fd, _TRAILER.size, size - _TRAILER.size)
            footer_off, tmagic = _TRAILER.unpack(trailer)
            if tmagic != TRAILER_MAGIC:
                raise FrameFormatError(
                    "{}: missing frame trailer (truncated spill: the "
                    "writer died before the footer landed)".format(path))
            flen = size - _TRAILER.size - footer_off
            if footer_off < _HEADER.size or flen <= 0:
                raise FrameFormatError(
                    "{}: frame footer offset {} out of range".format(
                        path, footer_off))
            try:
                footer = pickle.loads(os.pread(self._fd, flen, footer_off))
                self.index = footer["frames"]
                self.records = footer.get("records", 0)
            except Exception as e:
                raise FrameFormatError(
                    "{}: unreadable frame footer ({})".format(path, e))
        except Exception:
            os.close(self._fd)
            self._closed = True
            raise

    def __len__(self):
        return len(self.index)

    def read_frame(self, i):
        """Read and decompress frame ``i`` -> payload bytes (thread-safe)."""
        off, cid, raw_len, comp_len, _records = self.index[i]
        data = os.pread(self._fd, _FRAME.size + comp_len, off)
        if len(data) < _FRAME.size + comp_len:
            raise FrameFormatError(
                "{}: frame {} truncated (indexed {} bytes at {}, file has "
                "{})".format(self.path, i, comp_len, off, len(data)))
        hcid, _hraw, hcomp = _FRAME.unpack_from(data)
        if hcid != cid or hcomp != comp_len:
            raise FrameFormatError(
                "{}: frame {} header disagrees with the footer "
                "index".format(self.path, i))
        # a memoryview: no second copy of the payload bytes
        payload = codecs.decompress(cid, memoryview(data)[_FRAME.size:])
        if len(payload) != raw_len:
            raise FrameFormatError(
                "{}: frame {} inflated to {} bytes, index says {}".format(
                    self.path, i, len(payload), raw_len))
        return payload

    def _read_frame_timed(self, i):
        t0 = time.perf_counter()
        payload = self.read_frame(i)
        return payload, time.perf_counter() - t0

    def iter_payloads(self, prefetch=0, on_read=None, on_wait=None):
        """Yield every frame's payload in order.

        ``prefetch > 0`` keeps that many frames in flight on the shared
        read executor.  ``on_read(nbytes, seconds)`` fires per frame with
        the compressed bytes and the read-and-inflate seconds;
        ``on_wait(seconds)`` fires when the consumer blocked on a prefetch
        not yet done."""
        n = len(self.index)
        if prefetch <= 0 or n <= 1:
            try:
                for i in range(n):
                    payload, secs = self._read_frame_timed(i)
                    if on_read is not None:
                        on_read(self.index[i][3], secs)
                    yield payload
            finally:
                self.close()
            return

        pool = read_executor()

        def task(i):
            payload, secs = self._read_frame_timed(i)
            return payload, self.index[i][3], secs

        pending = deque()
        nxt = 0
        try:
            while nxt < min(prefetch, n):
                pending.append(pool.submit(task, nxt))
                nxt += 1
            while pending:
                fut = pending.popleft()
                waited = 0.0
                if not fut.done():
                    w0 = time.perf_counter()
                    fut.result()
                    waited = time.perf_counter() - w0
                payload, nbytes, secs = fut.result()
                if on_read is not None:
                    on_read(nbytes, secs)
                if on_wait is not None and waited:
                    on_wait(waited)
                if nxt < n:
                    pending.append(pool.submit(task, nxt))
                    nxt += 1
                yield payload
        finally:
            # An abandoned iterator (a merge that stopped early): wait out
            # the reads in flight before closing the fd under them.
            for fut in pending:
                if not fut.cancel():
                    try:
                        fut.result()
                    except Exception:
                        pass
            self.close()

    def close(self):
        if not self._closed:
            self._closed = True
            os.close(self._fd)


#: Threads of the shared bounded executor for prefetch reads across every
#: stream (a k-way merge over hundreds of runs must not start hundreds of
#: threads); started on first use.
READ_THREADS = min(4, os.cpu_count() or 1)
_read_pool = None
_read_pool_lock = threading.Lock()


def read_executor():
    global _read_pool
    if _read_pool is None:
        with _read_pool_lock:
            if _read_pool is None:
                _read_pool = ThreadPoolExecutor(
                    max_workers=READ_THREADS,
                    thread_name_prefix="dampr-io-read")
    return _read_pool


def dump_window_payload(keys, values, h1, h2):
    """One frame payload: a pickled columnar window."""
    return pickle.dumps((keys, values, h1, h2),
                        protocol=pickle.HIGHEST_PROTOCOL)


def load_window_payload(payload):
    return pickle.loads(payload)


def write_block_frames(block, f, codec, window, at_least_one=False):
    """Write one block onto ``f`` as framed ``window``-record slices;
    returns the (closed) FrameWriter for its stats."""
    w = FrameWriter(f, codec)
    w.add_block(block, window, at_least_one=at_least_one)
    w.close()
    return w
