"""Ingest: chunk planning, readahead, and splittable compressed taps.

Port of ``dampr_tpu/inputs.py``:

1. **Planning** (:func:`plan_chunks`) walks files, directories and globs
   (names sorted at every level, dotfiles hidden) into chunk specs.  The
   container format is sniffed from magic bytes, never the extension: a
   plain text file splits into line-aligned byte ranges, a plain gzip
   stream is one chunk, and a BGZF file (concatenated gzip members, each
   carrying its compressed size in the htslib ``BC`` extra subfield)
   splits at member boundaries, from its ``.gzi`` index when one ships
   beside it.
2. **Readahead** (:class:`Readahead`): a bounded background thread loads
   the next chunks' bytes (file read and inflate, both of which release
   the interpreter lock) while the current chunk computes.  It starts on
   the first ``read_bytes``, so per-record readers never pay for it, and
   ends when the runner closes it at the end of the stage.
3. **Taps**: :class:`PathInput`, :class:`TextInput`, :class:`MemoryInput`
   and :class:`UrlsInput`; every planned file chunk exposes
   ``read_bytes()`` for the byte-scanning mappers.
"""

import collections
import glob
import os
import threading
import zlib
from contextlib import closing

from .dataset import (Chunker, Dataset, GzipLineDataset, MemoryDataset,
                      TextLineDataset)

#: One planned unit of ingest.  ``kind`` is "text" (a byte range), "gzip"
#: (a whole unsplittable stream) or "bgzf" (a member-aligned compressed
#: range); ``start``/``end`` are offsets into the file as stored.
ChunkSpec = collections.namedtuple("ChunkSpec", "path start end kind size")

_GZIP_MAGIC = b"\x1f\x8b"

#: Chunks whose bytes the readahead thread loads ahead of the one being
#: computed (:class:`Readahead`).  0 turns it off.
READAHEAD_CHUNKS = 2


def _scan_tree(root, follow_links):
    """Depth-first walk yielding (path, size), names sorted, dotfiles
    hidden."""
    try:
        entries = sorted(os.scandir(root), key=lambda e: e.name)
    except NotADirectoryError:
        yield root, os.stat(root).st_size
        return
    except OSError:
        return
    dirs = []
    for e in entries:
        if e.name.startswith("."):
            continue
        try:
            if e.is_file(follow_symlinks=True):
                yield e.path, e.stat(follow_symlinks=True).st_size
            elif e.is_dir(follow_symlinks=follow_links):
                dirs.append(e.path)
        except OSError:
            continue
    for d in dirs:
        for item in _scan_tree(d, follow_links):
            yield item


def iter_files(paths, follow_links=True):
    """Expand globs / walk directories; yield (path, size)."""
    if not isinstance(paths, list):
        paths = [paths]
    for path_glob in paths:
        for path in sorted(glob.glob(path_glob)):
            if os.path.isfile(path):
                yield path, os.stat(path).st_size
            else:
                for item in _scan_tree(path, follow_links):
                    yield item


def read_paths(paths, follow_links=True):
    """Just the paths of :func:`iter_files`."""
    return (p for p, _size in iter_files(paths, follow_links))


def _sniff(path):
    """A file's container by magic bytes: "text", "gzip" or "bgzf"."""
    with open(path, "rb") as f:
        hdr = f.read(18)
    if len(hdr) < 18 or hdr[:2] != _GZIP_MAGIC:
        return "text"
    if hdr[3] & 4:  # FEXTRA
        xlen = int.from_bytes(hdr[10:12], "little")
        # BGZF puts exactly one subfield first: SI "BC", SLEN 2
        if (xlen >= 6 and hdr[12:14] == b"BC"
                and int.from_bytes(hdr[14:16], "little") == 2):
            return "bgzf"
    return "gzip"


def _bgzf_member_size(f, off):
    """Size of the BGZF member at ``off``, or None at EOF or on a header
    that is not BGZF."""
    f.seek(off)
    hdr = f.read(18)
    if len(hdr) < 18 or hdr[:2] != _GZIP_MAGIC or hdr[12:14] != b"BC":
        return None
    return int.from_bytes(hdr[16:18], "little") + 1


def _load_gzi(path):
    """Member offsets from a bgzip ``.gzi`` index beside ``path``, or None
    (uint64 count, then one (compressed, uncompressed) offset pair per
    member after the first)."""
    try:
        with open(path + ".gzi", "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < 8:
        return None
    n = int.from_bytes(data[:8], "little")
    if len(data) < 8 + 16 * n:
        return None
    offs = [0]
    for k in range(n):
        offs.append(int.from_bytes(data[8 + 16 * k:16 + 16 * k], "little"))
    return offs


def _bgzf_boundaries(path, size, chunk_size):
    """Member-aligned chunk boundaries: from the ``.gzi`` index when there
    is one, else one 18-byte header read per member.  None when the stream
    stops parsing as BGZF before ``size`` (a trailing plain-gzip member):
    the caller then reads the file whole and loses nothing."""
    offs = _load_gzi(path)
    if offs is not None:
        bounds = [0]
        acc = 0
        for a, b in zip(offs, offs[1:] + [size]):
            acc += b - a
            if acc >= chunk_size and b < size:
                bounds.append(b)
                acc = 0
        bounds.append(size)
        return bounds
    bounds = [0]
    with open(path, "rb") as f:
        off = 0
        acc = 0
        while off < size:
            msize = _bgzf_member_size(f, off)
            if msize is None:
                return None
            off += msize
            acc += msize
            if acc >= chunk_size and off < size:
                bounds.append(off)
                acc = 0
    bounds.append(size)
    return bounds


def plan_file(path, size, chunk_size):
    """Chunk specs for one file, split where its format allows."""
    kind = _sniff(path) if size else "text"
    if kind == "bgzf":
        bounds = _bgzf_boundaries(path, size, chunk_size)
        if bounds is None or len(bounds) < 2:
            kind = "gzip"
        else:
            return [ChunkSpec(path, a, b, "bgzf", size)
                    for a, b in zip(bounds, bounds[1:]) if b > a]
    if kind == "gzip":
        return [ChunkSpec(path, 0, size, "gzip", size)]
    return [ChunkSpec(path, at, min(at + chunk_size, size), "text", size)
            for at in range(0, max(size, 1), chunk_size)]


def plan_chunks(paths, chunk_size, follow_links=True):
    """The full ingest plan: every chunk of every matched file."""
    specs = []
    for path, size in iter_files(paths, follow_links):
        specs.extend(plan_file(path, size, chunk_size))
    return specs


def _spec_dataset(spec):
    if spec.kind == "gzip":
        return GzipLineDataset(spec.path)
    if spec.kind == "bgzf":
        return BgzfChunkDataset(spec.path, spec.start, spec.end, spec.size)
    return TextLineDataset(spec.path, spec.start,
                           None if spec.end >= spec.size else spec.end)


class Readahead(object):
    """Bounded background prefetcher over an ordered list of byte loaders.

    One daemon thread walks the loaders in order, holding at most
    ``depth`` buffers nobody has taken yet.  :meth:`take` of an index the
    thread has not reached is claimed and loaded by the caller, so taking
    out of order never deadlocks; an index mid-load is waited for, never
    loaded twice.  The thread starts on the first :meth:`take` and ends
    at :meth:`close`, which drops every buffer not taken."""

    def __init__(self, loaders, depth=2):
        self._loaders = loaders
        self._sem = threading.Semaphore(max(1, depth))
        self._lock = threading.Lock()
        self._results = {}
        self._claimed = set()
        self._events = [threading.Event() for _ in loaders]
        self._inflight = None
        self._thread = None
        self._closed = False

    def _run(self):
        for i, load in enumerate(self._loaders):
            self._sem.acquire()
            with self._lock:
                if self._closed:
                    return
                if i in self._claimed:
                    self._sem.release()
                    continue
                self._inflight = i
            try:
                data = load()
            except BaseException as e:  # raised again by take()
                data = e
            with self._lock:
                self._inflight = None
                if self._closed:
                    return
                self._results[i] = data
            self._events[i].set()

    def _pop(self, i):
        with self._lock:
            if self._closed:
                raise RuntimeError("readahead closed")
            data = self._results.pop(i)
            self._sem.release()
        if isinstance(data, BaseException):
            raise data
        return data

    def take(self, i):
        wait = False
        with self._lock:
            if self._closed:
                raise RuntimeError("readahead closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="dampr-readahead")
                self._thread.start()
            if i in self._results or self._inflight == i:
                wait = True
            else:
                self._claimed.add(i)
        if wait:
            self._events[i].wait()
            return self._pop(i)
        return self._loaders[i]()

    def close(self, timeout=10.0):
        """Stop the thread and drop every buffer not taken; a waiting
        :meth:`take` raises.  Joins the thread (a load in progress runs
        to its end first) and raises if it did not end in ``timeout``
        seconds."""
        with self._lock:
            self._closed = True
            self._results.clear()
            thread = self._thread
        self._sem.release()  # wakes a thread waiting for a free slot
        for ev in self._events:
            ev.set()
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)
            if thread.is_alive():
                raise RuntimeError(
                    "readahead thread did not stop within {} s".format(
                        timeout))


def close_readahead(chunks):
    """Close the readahead behind a stage's chunks, once the stage has
    ended or failed."""
    for ra in {id(c._readahead): c._readahead for c in chunks
               if isinstance(c, PrefetchedChunk)}.values():
        ra.close()


class PrefetchedChunk(object):
    """A planned chunk whose ``read_bytes`` the shared :class:`Readahead`
    serves; everything else goes to the inner dataset."""

    def __init__(self, inner, readahead, index):
        self._inner = inner
        self._readahead = readahead
        self._index = index

    def read_bytes(self):
        return self._readahead.take(self._index)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __repr__(self):
        return "Prefetched[{!r}]".format(self._inner)


class PathInput(Chunker):
    """File / directory / glob of newline-delimited text (plain, gzip or
    BGZF), planned up front and served through the readahead window."""

    def __init__(self, path, chunk_size=64 * 1024 ** 2, follow_links=True):
        self.path = path
        self.chunk_size = chunk_size
        self.follow_links = follow_links

    def chunks(self):
        specs = plan_chunks(self.path, self.chunk_size, self.follow_links)
        datasets = [_spec_dataset(s) for s in specs]
        if READAHEAD_CHUNKS and len(datasets) > 1:
            ra = Readahead([ds.read_bytes for ds in datasets],
                           READAHEAD_CHUNKS)
            datasets = [PrefetchedChunk(ds, ra, i)
                        for i, ds in enumerate(datasets)]
        for ds in datasets:
            yield ds


class TextInput(Chunker):
    """One file's chunks (container sniffed, no readahead)."""

    def __init__(self, path, chunk_size=64 * 1024 ** 2):
        self.path = path
        self.chunk_size = chunk_size

    def chunks(self):
        size = os.stat(self.path).st_size
        for spec in plan_file(self.path, size, self.chunk_size):
            yield _spec_dataset(spec)


class BgzfChunkDataset(Dataset):
    """A member-aligned compressed range ``[start, end)`` of a BGZF file,
    with :class:`~.dataset.TextLineDataset`'s line contract over the
    decompressed stream: a chunk with ``start > 0`` drops everything
    through the first newline of its own range, and a chunk that does not
    end the file inflates further members through the line that crosses
    its end.  Adjacent chunks read every line once; a range that is one
    partial line owns nothing."""

    def __init__(self, path, start, end, file_size):
        self.path = path
        self.start = start
        self.end = end
        self.file_size = file_size

    @staticmethod
    def _inflate(raw):
        """Concatenated gzip members, decompressed.  BGZF members are hopped
        by their BSIZE, so each inflate sees one member; anything else (a
        corrupt index) takes the generic member chain for the tail."""
        out = []
        mv = memoryview(raw)
        off, n = 0, len(raw)
        while off < n:
            if (n - off >= 18 and bytes(mv[off:off + 2]) == _GZIP_MAGIC
                    and bytes(mv[off + 12:off + 14]) == b"BC"):
                msize = int.from_bytes(mv[off + 16:off + 18], "little") + 1
                dec = zlib.decompressobj(wbits=31)
                out.append(dec.decompress(mv[off:off + msize]))
                off += msize
            else:
                data = bytes(mv[off:])
                while data:
                    dec = zlib.decompressobj(wbits=31)
                    out.append(dec.decompress(data))
                    data = dec.unused_data
                break
        return b"".join(out)

    def read_bytes(self):
        with open(self.path, "rb") as f:
            f.seek(self.start)
            own = self._inflate(f.read(self.end - self.start))
            if self.start > 0:
                nl = own.find(b"\n")
                if nl < 0:
                    return b""  # one partial line: the left neighbor's
                own = own[nl + 1:]
            if self.end < self.file_size:
                ext = []
                off = self.end
                while off < self.file_size:
                    msize = _bgzf_member_size(f, off)
                    if msize is None:
                        break
                    f.seek(off)
                    piece = self._inflate(f.read(msize))
                    off += msize
                    nl = piece.find(b"\n")
                    if nl >= 0:
                        ext.append(piece[:nl + 1])
                        break
                    ext.append(piece)
                own += b"".join(ext)
        return own

    def read(self):
        # Keys are ints (the compressed chunk start plus the line's local
        # decompressed position), in the text taps' int64 lane; they
        # identify lines, they are not offsets into the stream.
        data = self.read_bytes()
        pos = 0
        n = len(data)
        while pos < n:
            nl = data.find(b"\n", pos)
            end = n if nl < 0 else nl
            yield self.start + pos, data[pos:end].decode("utf-8")
            pos = end + 1

    def __repr__(self):
        return "Bgzf[path={},start={},end={}]".format(
            self.path, self.start, self.end)


class MemoryInput(Chunker):
    """An in-memory (k, v) list cut into about ``partitions`` chunks of
    ``len // partitions`` records (the last chunk takes the remainder)."""

    def __init__(self, items, partitions=50):
        self.items = items
        self.partitions = min(len(items), partitions)

    def chunks(self):
        if self.partitions == 0:
            yield MemoryDataset(self.items)
            return
        chunk_size = max(1, len(self.items) // self.partitions)
        for start in range(0, len(self.items), chunk_size):
            yield MemoryDataset(self.items[start:start + chunk_size])


class UrlsInput(Chunker):
    """One chunk per URL; HTTP and connection errors are skipped unless
    ``skip_on_error`` is False."""

    def __init__(self, urls, skip_on_error=True):
        self.urls = urls
        self.skip_on_error = skip_on_error

    def chunks(self):
        for url in self.urls:
            yield UrlDataset(url, self.skip_on_error)


class UrlDataset(Dataset):
    """The lines of one URL's body, keyed by line number."""

    def __init__(self, url, skip_on_error=True):
        self.url = url
        self.skip_on_error = skip_on_error

    def read(self):
        from urllib.error import HTTPError, URLError
        from urllib.request import urlopen

        try:
            with closing(urlopen(self.url)) as h:
                for i, line in enumerate(h):
                    yield i, line.decode("utf-8")
        except (HTTPError, URLError):
            if not self.skip_on_error:
                raise

    def __repr__(self):
        return "Url[{}]".format(self.url)
