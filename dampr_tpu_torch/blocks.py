"""Columnar KV record blocks — the data substrate.

Port of ``dampr_tpu/blocks.py``.  A :class:`Block` holds parallel columns:

- ``keys``:   numpy array — int64/float64 lanes, or object (strings, tuples);
- ``values``: numpy array — numeric lanes (device-foldable) or object;
- ``h1/h2``:  cached dual uint32 hash lanes (:mod:`.ops.hashing`) used for
              partition routing and sort-based grouping.

Blocks are the unit of streaming, spill and shuffle.  They always carry the
real key column, so grouping verifies that records sharing a 64-bit hash
share a key and sub-groups on a collision: exact, never hash-approximate.
"""

import numpy as np

from . import settings
from .ops import hashing

_I64_MIN = -(2 ** 63)
_I64_MAX = 2 ** 63 - 1


def _tuple_column(xs):
    """Type-uniform numeric tuples -> a 2D composite lane (all int ->
    int64, all float -> float64); None when they don't qualify."""
    w = len(xs[0])
    if not 2 <= w <= 8 or set(map(len, xs)) != {w}:
        return None
    ts = set()
    for x in xs:
        ts.update(map(type, x))
        if len(ts) > 1:
            return None
    if ts == {int}:
        try:
            return np.array(xs, dtype=np.int64)
        except OverflowError:
            return None
    if ts == {float}:
        return np.array(xs, dtype=np.float64)
    return None


def _column_from_list(xs, composite=False):
    """The tightest column for a list of Python values.  ``composite``
    (value columns only) lets uniform numeric tuples build a 2D lane."""
    n = len(xs)
    ts = set(map(type, xs))
    if composite and ts == {tuple}:
        col2d = _tuple_column(xs)
        if col2d is not None:
            return col2d
    if ts == {bool}:
        return np.fromiter(xs, dtype=np.bool_, count=n)
    if ts == {int}:
        try:
            arr = np.empty(n, dtype=np.int64)
            for i, x in enumerate(xs):
                arr[i] = x
            return arr
        except OverflowError:
            pass
    elif ts == {float}:
        return np.fromiter(xs, dtype=np.float64, count=n)
    elif ts == {float, int}:
        # float64 only when every int is exactly representable
        if all(isinstance(x, float) or abs(x) <= 2 ** 53 for x in xs):
            return np.array([float(x) for x in xs], dtype=np.float64)
    out = np.empty(n, dtype=object)
    out[:] = xs
    return out


def is_numeric(col):
    return col.dtype != object


def pylist(col):
    """Column -> plain-Python list (numpy scalars unboxed, 2D lanes back
    to tuples)."""
    lst = col.tolist()
    if col.ndim == 2:
        return [tuple(r) for r in lst]
    if col.dtype == object:
        lst = [x.item() if isinstance(x, np.generic) else x for x in lst]
    return lst


class Block(object):
    __slots__ = ("keys", "values", "h1", "h2")

    def __init__(self, keys, values, h1=None, h2=None):
        if len(keys) != len(values):
            raise ValueError("key and value columns differ in length")
        self.keys = keys
        self.values = values
        self.h1 = h1
        self.h2 = h2

    @classmethod
    def from_pairs(cls, pairs):
        n = len(pairs)
        ks = [None] * n
        vs = [None] * n
        for i, (k, v) in enumerate(pairs):
            ks[i] = k
            vs[i] = v
        return cls(_column_from_list(ks),
                   _column_from_list(vs, composite=True))

    @classmethod
    def from_lists(cls, ks, vs):
        """A block from parallel key/value lists (the batched record
        path's native shape: no per-record tuple boxing)."""
        if len(ks) != len(vs):
            raise ValueError("key and value lists differ in length")
        return cls(_column_from_list(ks),
                   _column_from_list(vs, composite=True))

    @classmethod
    def empty(cls):
        return cls(np.empty(0, dtype=object), np.empty(0, dtype=object),
                   np.empty(0, dtype=np.uint32), np.empty(0, dtype=np.uint32))

    @classmethod
    def concat(cls, blocks):
        blocks = [b for b in blocks if len(b)]
        if not blocks:
            return cls.empty()
        if len(blocks) == 1:
            return blocks[0]
        keys = _concat_cols([b.keys for b in blocks])
        values = _concat_cols([b.values for b in blocks])
        if all(b.h1 is not None for b in blocks):
            h1 = np.concatenate([b.h1 for b in blocks])
            h2 = np.concatenate([b.h2 for b in blocks])
        else:
            h1 = h2 = None
        return cls(keys, values, h1, h2)

    def __len__(self):
        return len(self.keys)

    @property
    def numeric_values(self):
        return is_numeric(self.values)

    def nbytes(self):
        kb = self.keys.nbytes if is_numeric(self.keys) else len(self.keys) * 64
        vb = (self.values.nbytes if self.numeric_values
              else len(self.values) * 64)
        hb = 0 if self.h1 is None else self.h1.nbytes * 2
        return kb + vb + hb

    def to_lists(self):
        return pylist(self.keys), pylist(self.values)

    def iter_pairs(self, _window=8192):
        """(k, v) pairs, boxing at most ``_window`` records at a time."""
        n = len(self.keys)
        if n <= _window:
            kl, vl = self.to_lists()
            return zip(kl, vl)

        def gen():
            for i in range(0, n, _window):
                sub = Block(self.keys[i:i + _window],
                            self.values[i:i + _window])
                kl, vl = sub.to_lists()
                yield from zip(kl, vl)

        return gen()

    def hashes(self):
        if self.h1 is None:
            self.h1, self.h2 = hashing.hash_keys(self.keys)
        return self.h1, self.h2

    def slice(self, a, b):
        """Records ``[a, b)`` as array views, hash lanes included."""
        return Block(self.keys[a:b], self.values[a:b],
                     None if self.h1 is None else self.h1[a:b],
                     None if self.h2 is None else self.h2[a:b])

    def take(self, idx):
        return Block(
            self.keys.take(idx),
            self.values[idx],  # fancy indexing gathers whole 2D rows
            None if self.h1 is None else self.h1.take(idx),
            None if self.h2 is None else self.h2.take(idx),
        )

    def sort_by_hash(self):
        """Stable sort by (h1, h2): a mergeable run."""
        h1, h2 = self.hashes()
        return self.take(np.lexsort((h2, h1)))

    def partition_ids(self, n_partitions):
        h1, _ = self.hashes()
        return (h1 % np.uint32(n_partitions)).astype(np.int32)

    def split_by_partition(self, n_partitions):
        """Route records to partitions by ``h1 % P``: {pid: Block} for the
        non-empty partitions."""
        if not len(self):
            return {}
        pids = self.partition_ids(n_partitions)
        order = np.argsort(pids, kind="stable")
        sorted_pids = pids[order]
        bounds = np.flatnonzero(np.diff(sorted_pids)) + 1
        out = {}
        start = 0
        for end in list(bounds) + [len(sorted_pids)]:
            if end > start:
                out[int(sorted_pids[start])] = self.take(order[start:end])
            start = end
        return out


def _concat_cols(cols):
    widths = {c.shape[1] if c.ndim == 2 else 0 for c in cols}
    if len(widths) > 1:
        return _as_object_concat(cols)
    if widths != {0}:
        if len({c.dtype for c in cols}) == 1:
            return np.concatenate(cols)
        return _as_object_concat(cols)
    dtypes = {c.dtype for c in cols}
    if len(dtypes) == 1 and object not in dtypes:
        return np.concatenate(cols)
    if object not in dtypes:
        # Mixed numeric dtypes: bools never silently become numbers, and
        # int64 joins float64 only when every int is float-exact.
        if any(dt == np.bool_ for dt in dtypes):
            return _as_object_concat(cols)
        target = np.result_type(*dtypes)
        if target.kind == "f":
            for c in cols:
                if c.dtype.kind in "iu" and len(c) and (
                        np.abs(c).max() > 2 ** 53):
                    return _as_object_concat(cols)
        return np.concatenate([c.astype(target) for c in cols])
    return _as_object_concat(cols)


def _as_object_concat(cols):
    total = sum(len(c) for c in cols)
    out = np.empty(total, dtype=object)
    at = 0
    for c in cols:
        if c.dtype == object:
            out[at: at + len(c)] = c
        elif c.ndim == 2:
            out[at: at + len(c)] = [tuple(r) for r in c.tolist()]
        else:
            out[at: at + len(c)] = [x.item() for x in c]
        at += len(c)
    return out


def merge_sorted_streams(streams):
    """Vectorized k-way merge over streams of KEY-sorted, NaN-free blocks,
    holding one window per stream.  Each round gathers every buffered
    record ``<=`` the smallest window-last key (all such records are
    already buffered), stable-sorts that slice and emits it; a stream whose
    window ends exactly at the bound extends through ties so equal keys
    never straddle an emission.  A tie group over a quarter of the memory
    budget drains over later rounds instead (order holds, tie order may
    degrade)."""
    from .obs import metrics as _metrics
    from .obs import trace as _trace

    its = [iter(s) for s in streams]
    n = len(its)
    # merge fan-in per merge: the distribution the planner's clamp bounds
    _metrics.observe("merge.kway_streams", n)

    def gen():
        buf = [None] * n
        last = [None] * n

        def load(i):
            while True:
                try:
                    b = next(its[i])
                except StopIteration:
                    buf[i] = None
                    last[i] = None
                    return
                if len(b):
                    buf[i] = b
                    k = b.keys[-1]
                    last[i] = k.item() if isinstance(k, np.generic) else k
                    return

        for i in range(n):
            load(i)
        while True:
            t0 = _trace.now()
            bound = None
            for i in range(n):
                if buf[i] is not None and (bound is None or last[i] < bound):
                    bound = last[i]
            if bound is None:
                return
            pieces = []
            ext_budget = max(settings.max_memory_per_stage // 4, 1 << 20)
            for i in range(n):
                b = buf[i]
                if b is None:
                    continue
                end = int(np.searchsorted(b.keys, bound, side="right"))
                if end < len(b):
                    if end:
                        pieces.append(b.slice(0, end))
                        buf[i] = b.slice(end, len(b))
                    continue
                pieces.append(b)
                buf[i] = None
                last[i] = None
                while True:
                    try:
                        nxt = next(its[i])
                    except StopIteration:
                        break
                    if not len(nxt):
                        continue
                    e2 = int(np.searchsorted(nxt.keys, bound, side="right"))
                    if e2:
                        p = nxt.slice(0, e2)
                        pieces.append(p)
                        ext_budget -= p.nbytes()
                    if e2 < len(nxt):
                        buf[i] = nxt.slice(e2, len(nxt))
                        k = buf[i].keys[-1]
                        last[i] = (k.item()
                                   if isinstance(k, np.generic) else k)
                        break
                    if ext_budget <= 0:
                        load(i)
                        break
            merged = Block.concat(pieces)
            if len(merged):
                # one span per round (a round drains at least a window):
                # gather and sort, not the consumer's time
                _trace.complete("merge", "k-way-round", t0,
                                records=len(merged), streams=n)
                _metrics.counter_add("merge.kway_records", len(merged))
                yield merged.take(np.argsort(merged.keys, kind="stable"))

    return gen()


class BlockBuilder(object):
    """Accumulates (k, v) pairs and emits Blocks of ``batch_size`` records."""

    def __init__(self, batch_size):
        self.batch_size = batch_size
        self._buf = []

    def add(self, k, v):
        self._buf.append((k, v))
        if len(self._buf) >= self.batch_size:
            return self.flush()
        return None

    def flush(self):
        if not self._buf:
            return None
        blk = Block.from_pairs(self._buf)
        self._buf = []
        return blk
