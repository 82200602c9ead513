"""An inverted index over text files, built with the port's blocks and
segment grouping (port of ``dampr_tpu/utils/indexer.py``):

- **build**: each file's (token, byte-offset) postings accumulate as
  columnar Blocks and group through ``ops/segment.sort_and_group``.  Each
  token stores one row: its offsets as a packed int64 array (ascending:
  the stable sort keeps scan order).
- **union / intersect**: the matching tokens' offset arrays combine with
  ``np.unique`` over their concatenation; ``intersect`` counts matched
  postings per offset (a key appearing twice on a line counts twice
  toward ``min_match``).
- Lookups stream the matching lines back through a Dampr pipeline, one
  seek per offset.

The on-disk container stays a hidden per-file SQLite DB (one row per
token), so index files remain single ordinary files; all queries are
parameterized (hostile keys select nothing — they can never execute).
"""

import logging
import os
import sqlite3

import numpy as np

from ..blocks import Block
from ..dampr import Dampr
from ..inputs import read_paths
from ..ops import segment

log = logging.getLogger("dampr_tpu_torch.indexer")

#: Postings batch: (token, offset) pairs accumulate into blocks of this
#: many records before grouping.
_BATCH = 1 << 16


class Indexer(object):
    def __init__(self, path, suffix=".index"):
        self.path = path
        self.suffix = suffix

    def get_idx(self, path):
        dirname, base = os.path.split(path)
        return os.path.join(dirname, "." + base + self.suffix)

    def exists(self, path):
        return os.path.isfile(self.get_idx(path))

    # -- build -------------------------------------------------------------
    def _index_one(self, fname, key_f):
        """Group one file's postings through the segment kernels and store
        one packed row per token.  Returns the posting count."""
        ks, vs, blocks = [], [], []
        off = 0
        with open(fname, "rb") as f:
            for raw in f:
                # key_f sees the line with its terminator, as in the JAX
                # package
                for tok in key_f(raw.decode("utf-8")):
                    ks.append(tok)
                    vs.append(off)
                off += len(raw)
                if len(ks) >= _BATCH:
                    blocks.append(Block.from_lists(ks, vs))
                    ks, vs = [], []
        if ks:
            blocks.append(Block.from_lists(ks, vs))

        idx = self.get_idx(fname)
        if os.path.isfile(idx):
            os.unlink(idx)
        db = sqlite3.connect(idx)
        db.execute("CREATE TABLE postings (key TEXT, offs BLOB)")
        total = 0
        if blocks:
            blk = Block.concat(blocks)
            total = len(blk)
            groups = segment.sort_and_group(blk)
            sb = groups.block
            starts, ends = groups.bounds()

            def rows():
                for i in range(len(starts)):
                    k = sb.keys[starts[i]]
                    offs = np.asarray(
                        sb.values[starts[i]:ends[i]], dtype=np.int64)
                    yield (k.item() if isinstance(k, np.generic) else k,
                           offs.tobytes())

            db.executemany("INSERT INTO postings VALUES (?, ?)", rows())
            db.execute("CREATE INDEX postings_key ON postings (key)")
        db.commit()
        db.close()
        return total

    def build(self, key_f, force=False):
        """Index every file under ``path``: ``key_f(line) -> iterable of
        keys``.  Returns the total postings indexed, as ``[(1, total)]``."""
        paths = sorted(read_paths(self.path, False))
        return (Dampr.memory(paths)
                .filter(lambda fname: force or not self.exists(fname))
                .map(lambda fname: self._index_one(fname, key_f))
                .fold_by(key=lambda _x: 1, binop=lambda x, y: x + y)
                .read(name="indexing"))

    # -- query -------------------------------------------------------------
    def _offsets_for(self, fname, keys):
        """Concatenated (with multiplicity) offset arrays of the matching
        tokens."""
        db = sqlite3.connect(self.get_idx(fname))
        try:
            marks = ",".join("?" for _ in keys)
            rows = db.execute(
                "SELECT offs FROM postings WHERE key IN ({})".format(marks),
                tuple(keys)).fetchall()
        finally:
            db.close()
        if not rows:
            return np.empty(0, dtype=np.int64)
        return np.concatenate(
            [np.frombuffer(blob, dtype=np.int64) for (blob,) in rows])

    def _seek_lines(self, select_offsets, keys):
        keys = list(keys)

        def read_matches(fname):
            offs = select_offsets(self._offsets_for(fname, keys))
            with open(fname, "rb") as f:
                for off in offs.tolist():
                    f.seek(off)
                    yield f.readline().decode("utf-8")

        paths = sorted(read_paths(self.path, False))
        return Dampr.memory(paths).flat_map(read_matches)

    def union(self, keys):
        """Lines containing any of the keys."""
        if not isinstance(keys, (list, tuple)):
            keys = [keys]
        return self._seek_lines(np.unique, keys)

    def intersect(self, keys, min_match=None):
        """Lines containing at least ``min_match`` of the keys (all, by
        default; a float is a fraction of the key count)."""
        if not isinstance(keys, (list, tuple)):
            keys = [keys]
        if min_match is None:
            min_match = len(keys)
        if isinstance(min_match, float):
            min_match = int(min_match * len(keys))

        def at_least(offs, m=min_match):
            uniq, counts = np.unique(offs, return_counts=True)
            return uniq[counts >= m]

        return self._seek_lines(at_least, keys)
