"""Ingest: chunk planning over plain text files and in-memory lists.

Port of the plain-text part of ``dampr_tpu/inputs.py``: :func:`plan_chunks`
walks files, directories and globs (names sorted at every level, dotfiles
hidden) into line-aligned byte-range chunks; :class:`MemoryInput` cuts a
list into chunks exactly as the reference does.  Compressed inputs (gzip,
BGZF) and the readahead prefetcher are a later slice; a gzip file is
refused with an error, never read as text.
"""

import collections
import glob
import os

from .dataset import Chunker, MemoryDataset, TextLineDataset

#: One planned unit of ingest: a byte range ``[start, end)`` of a file.
ChunkSpec = collections.namedtuple("ChunkSpec", "path start end size")

_GZIP_MAGIC = b"\x1f\x8b"


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


def plan_file(path, size, chunk_size):
    """Byte-range chunk specs for one plain text file."""
    if size:
        with open(path, "rb") as f:
            if f.read(2) == _GZIP_MAGIC:
                raise NotImplementedError(
                    "{}: compressed inputs are not supported by "
                    "dampr_tpu_torch yet".format(path))
    return [ChunkSpec(path, at, min(at + chunk_size, size), size)
            for at in range(0, max(size, 1), chunk_size)]


def plan_chunks(paths, chunk_size, follow_links=True):
    """The full ingest plan: every chunk of every matched file."""
    specs = []
    for path, size in iter_files(paths, follow_links):
        specs.extend(plan_file(path, size, chunk_size))
    return specs


def _spec_dataset(spec):
    return TextLineDataset(spec.path, spec.start,
                           None if spec.end >= spec.size else spec.end)


class PathInput(Chunker):
    """File / directory / glob of newline-delimited text."""

    def __init__(self, path, chunk_size=64 * 1024 ** 2, follow_links=True):
        self.path = path
        self.chunk_size = chunk_size
        self.follow_links = follow_links

    def chunks(self):
        for spec in plan_chunks(self.path, self.chunk_size,
                                self.follow_links):
            yield _spec_dataset(spec)


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


class TextInput(Chunker):
    """One text file's chunks."""

    def __init__(self, path, chunk_size=64 * 1024 ** 2):
        self.path = path
        self.chunk_size = chunk_size

    def chunks(self):
        size = os.stat(self.path).st_size
        for spec in plan_file(self.path, size, self.chunk_size):
            yield _spec_dataset(spec)

