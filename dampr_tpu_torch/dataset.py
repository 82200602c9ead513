"""Read-side datasets: the record sources stages consume.

Port of ``dampr_tpu/dataset.py``: plain text, a plain gzip file as one
chunk, in-memory records, and block views, with the final read's
``OrderKey`` and ``merged_read``.  Every dataset
yields ``(key, value)`` pairs; text taps yield ``(byte_offset, line)``.
The batched record path reads through ``read_lists(batch)`` where a
dataset has it: parallel key and value lists of at most ``batch``
records, the same records in the same order as ``read()``.
"""

import gzip
import itertools
import os

import numpy as np

from .blocks import Block


class Chunker(object):
    """Splittable input: yields independent Datasets to map in parallel."""

    def chunks(self):
        raise NotImplementedError()


class Dataset(Chunker):
    """A stream of (key, value) records."""

    def read(self):
        raise NotImplementedError()

    def grouped_read(self):
        """Consecutive equal keys as ``(key, values)`` groups (meaningful on
        key-sorted data)."""
        for key, group in itertools.groupby(self.read(), key=lambda kv: kv[0]):
            yield key, (kv[1] for kv in group)

    def delete(self):
        pass

    def __iter__(self):
        return self.read()

    def chunks(self):
        yield self


class EmptyDataset(Dataset):
    def read(self):
        return iter(())


class MemoryDataset(Dataset):
    """An in-memory list of (k, v) pairs."""

    def __init__(self, kvs):
        self.kvs = kvs

    def read(self):
        return iter(self.kvs)

    def read_lists(self, batch):
        kvs = self.kvs if isinstance(self.kvs, list) else list(self.kvs)
        for i in range(0, len(kvs), batch):
            part = kvs[i:i + batch]
            yield [k for k, _ in part], [v for _, v in part]


class BlockDataset(Dataset):
    """View over a list of materialized block refs."""

    def __init__(self, refs):
        self.refs = list(refs)

    def iter_blocks(self):
        for r in self.refs:
            yield r.get() if hasattr(r, "get") else r

    def read(self):
        for blk in self.iter_blocks():
            for kv in blk.iter_pairs():
                yield kv

    def read_lists(self, batch):
        """Each block's lanes unboxed a whole lane at a time."""
        for blk in self.iter_blocks():
            if not len(blk):
                continue
            ks, vs = blk.to_lists()
            for i in range(0, len(ks), batch):
                yield ks[i:i + batch], vs[i:i + batch]

    def concat(self):
        """Every block as one (an empty Block when there are none)."""
        return Block.concat(list(self.iter_blocks()))


class StreamDataset(Dataset):
    """A single-shot iterator of records."""

    def __init__(self, it):
        self.it = it

    def read(self):
        return self.it


class CatDataset(Dataset):
    """Concatenation of several datasets; as a stage input each one is a
    chunk of its own (``Dampr.read_input(*datasets)``)."""

    def __init__(self, datasets):
        self.datasets = list(datasets)

    def read(self):
        for ds in self.datasets:
            for kv in ds.read():
                yield kv

    def chunks(self):
        for ds in self.datasets:
            yield ds

    def delete(self):
        for ds in self.datasets:
            ds.delete()


class TextLineDataset(Dataset):
    """Byte-range slice ``[start, end)`` of a newline-delimited text file.

    A chunk with ``start > 0`` skips through the first newline at or after
    ``start``; every chunk reads through the line that crosses ``end``.
    Adjacent chunks therefore read each line exactly once.  Keys are the
    byte offsets of each line's first byte."""

    def __init__(self, path, start=0, end=None):
        self.path = path
        self.start = start
        self.end = end

    def _owned_start(self, f):
        if self.start > 0:
            f.seek(self.start)
            f.readline()
            return f.tell()
        f.seek(0)
        return 0

    def read(self):
        with open(self.path, "rb") as f:
            pos = self._owned_start(f)
            if self.start > 0 and self.end is not None and pos > self.end:
                return
            for raw in f:
                yield pos, raw.decode("utf-8").rstrip("\n")
                pos += len(raw)
                if self.end is not None and pos > self.end:
                    break

    def read_lists(self, batch):
        """``read()``'s records as parallel lists: lines split at the C
        level over the bounded byte blocks, keys from a cumulative sum of
        the line lengths."""
        carry = b""
        with open(self.path, "rb") as f:
            pos = self._owned_start(f)
        for buf in self.iter_byte_blocks():
            data = carry + buf if carry else buf
            lines = data.split(b"\n")
            carry = lines.pop()  # the partial last line, or b""
            if not lines:
                continue
            lens = np.fromiter(map(len, lines), dtype=np.int64,
                               count=len(lines)) + 1
            offs = pos + np.concatenate(
                ([0], np.cumsum(lens[:-1], dtype=np.int64)))
            pos += int(lens.sum())
            ks = offs.tolist()
            vs = [r.decode("utf-8") for r in lines]
            for i in range(0, len(ks), batch):
                yield ks[i:i + batch], vs[i:i + batch]
        if carry:
            yield [pos], [carry.decode("utf-8")]

    def read_bytes(self):
        """The chunk's owned bytes as one buffer."""
        with open(self.path, "rb") as f:
            real_start = self._owned_start(f)
            if self.end is None:
                return f.read()
            if real_start > self.end:
                return b""
            f.seek(self.end)
            f.readline()
            real_end = f.tell()
            f.seek(real_start)
            return f.read(real_end - real_start)

    def iter_byte_blocks(self, block_size=4 * 1024 ** 2):
        """The chunk's owned bytes in bounded blocks (same ownership)."""
        with open(self.path, "rb") as f:
            real_start = self._owned_start(f)
            if self.end is None:
                while True:
                    b = f.read(block_size)
                    if not b:
                        return
                    yield b
            if real_start > self.end:
                return
            at = real_start
            while at < self.end:
                b = f.read(min(block_size, self.end - at))
                if not b:
                    return
                at += len(b)
                yield b
            tail = f.readline()  # extend through the line crossing `end`
            if tail:
                yield tail

    def __repr__(self):
        return "Text[path={},start={},end={}]".format(
            self.path, self.start, self.end)


class GzipLineDataset(Dataset):
    """A plain (not BGZF) gzip text file as one unsplittable chunk; keys
    are the lines' offsets in the decompressed stream."""

    def __init__(self, path):
        self.path = path

    def read(self):
        with gzip.open(self.path, "rb") as f:
            pos = 0
            for raw in f:
                yield pos, raw.decode("utf-8").rstrip("\n")
                pos += len(raw)

    def read_bytes(self):
        with gzip.open(self.path, "rb") as f:
            return f.read()

    def iter_byte_blocks(self, block_size=4 * 1024 ** 2):
        """The decompressed bytes in bounded blocks, so a scan never holds
        the whole expansion."""
        with gzip.open(self.path, "rb") as f:
            while True:
                b = f.read(block_size)
                if not b:
                    return
                yield b

    def __repr__(self):
        return "GzipFile[path={}]".format(self.path)


class SinkDataset(Dataset):
    """Reads back a sink's part-file as (offset, line)."""

    def __init__(self, path):
        self.path = path

    def read(self):
        return TextLineDataset(self.path).read()

    def delete(self):
        if os.path.exists(self.path):
            os.unlink(self.path)


class OrderKey(object):
    """Total order over record keys: native comparison where the types
    allow it, the type name otherwise (mixed-type outputs stay
    readable)."""

    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        a, b = self.k, other.k
        try:
            return bool(a < b)
        except TypeError:
            return type(a).__name__ < type(b).__name__


def merged_read(datasets):
    """K-way merge of key-sorted datasets by key (stable: ties come in
    dataset order)."""
    import heapq

    its = [ds.read() for ds in datasets]
    return heapq.merge(*its, key=lambda kv: OrderKey(kv[0]))
