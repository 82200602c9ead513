"""What every maker shares: the seed's generator, the writer of a corpus
in its storage, the read that puts it in the page cache, and the chunk
size.  Makers (``makers/<name>.py``) make the data; nothing here names a
traffic mix or a configuration.

Storage (a traffic file's ``storage``):

- ``"plain"``: the bytes as they are;
- ``"bgzf"``: one BGZF file as ``bgzip`` writes it by default, made here
  with the standard library's ``zlib`` alone: members of at most 65,280
  bytes of input (htslib's ``BGZF_BLOCK_SIZE``), each deflated at zlib's
  default level 6 under an 18-byte gzip header whose extra field holds the
  ``BC`` subfield (the member's size less one), then the standard 28-byte
  empty member that ends the file, and no ``.gzi`` index.
"""

import concurrent.futures
import hashlib
import math
import os
import struct
import zlib

import numpy as np

#: The file name's ending for each storage.
SUFFIX = {"plain": ".txt", "bgzf": ".txt.gz"}

#: A BGZF member's input at most (htslib's ``BGZF_BLOCK_SIZE``, 0xff00): a
#: member then stays within 64 KiB even where deflate cannot shrink it.
BGZF_BLOCK = 0xff00

#: zlib's default level, which ``bgzip`` uses unless told otherwise.
BGZF_LEVEL = 6

#: A member's gzip header up to its size: magic, deflate, FEXTRA, no time,
#: no extra flags, unknown OS, 6 bytes of extra field: ``BC``, length 2.
_BGZF_HEAD = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"

#: The empty member that ends every BGZF file.
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def _seed_rng(seed):
    """A generator for any whole number, negative or past 64 bits."""
    seed = int(seed)
    words = []
    mag = abs(seed)
    while True:
        words.append(mag & 0xFFFFFFFF)
        mag >>= 32
        if not mag:
            break
    return np.random.default_rng(np.random.SeedSequence(
        words + [1 if seed < 0 else 0]))


def bgzf_member(data):
    """One BGZF member holding ``data`` (at most :data:`BGZF_BLOCK`
    bytes)."""
    if len(data) > BGZF_BLOCK:
        raise ValueError("a BGZF member holds at most {} bytes, not {}"
                         .format(BGZF_BLOCK, len(data)))
    c = zlib.compressobj(BGZF_LEVEL, zlib.DEFLATED, -15)
    body = c.compress(data) + c.flush()
    size = len(_BGZF_HEAD) + 2 + len(body) + 8
    return b"".join((_BGZF_HEAD, struct.pack("<H", size - 1), body,
                     struct.pack("<II", zlib.crc32(data), len(data))))


class BgzfWriter(object):
    """Writes BGZF to the open binary file ``f``: whole members as the
    input fills them, the last partial one and the end member at
    :meth:`close`.  A write's members are deflated on ``threads`` threads
    (``zlib`` releases the interpreter lock) and written in order."""

    def __init__(self, f, threads):
        self.f = f
        self.members = 0
        self.stored_bytes = 0
        self._tail = b""
        self._pool = concurrent.futures.ThreadPoolExecutor(threads)

    def _put(self, blocks):
        for member in self._pool.map(bgzf_member, blocks):
            self.f.write(member)
            self.members += 1
            self.stored_bytes += len(member)

    def write(self, data):
        buf = memoryview(self._tail + data)
        whole = len(buf) - len(buf) % BGZF_BLOCK
        self._put([buf[i:i + BGZF_BLOCK]
                   for i in range(0, whole, BGZF_BLOCK)])
        self._tail = bytes(buf[whole:])

    def close(self):
        try:
            if self._tail:
                self._put([self._tail])
            self.f.write(BGZF_EOF)
            self.stored_bytes += len(BGZF_EOF)
        finally:
            self._pool.shutdown()


def write_copies(path, data, copies, storage="plain"):
    """``copies`` copies of ``data`` (bytes) into ``path``, stored as
    ``storage``, one copy at a time: the corpus is never held whole.
    Returns ``{"stored_bytes"}``, and for BGZF ``"members"``: the members
    that hold data, the end member not counted."""
    if storage not in SUFFIX:
        raise ValueError("unknown storage {!r} (known: {})".format(
            storage, ", ".join(sorted(SUFFIX))))
    with open(path, "wb") as f:
        if storage == "plain":
            for _ in range(int(copies)):
                f.write(data)
            return {"stored_bytes": len(data) * int(copies)}
        w = BgzfWriter(f, min(8, len(os.sched_getaffinity(0))))
        try:
            for _ in range(int(copies)):
                w.write(data)
        finally:
            w.close()
        return {"stored_bytes": w.stored_bytes, "members": w.members}


def read_once(path, block=1 << 24):
    """Read the file through, so that it sits in the page cache.  Returns
    its size and its SHA-256 (hex)."""
    n = 0
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(block)
            if not b:
                return n, digest.hexdigest()
            n += len(b)
            digest.update(b)


def chunk_size(corpus_bytes, chunks):
    """The chunk size that cuts the corpus into ``chunks`` chunks."""
    return int(math.ceil(corpus_bytes / float(chunks)))
