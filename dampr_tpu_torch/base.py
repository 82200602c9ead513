"""Mapper / reducer building blocks of the DSL.

Port of the parts of ``dampr_tpu/base.py`` the slice's path uses: the
``Mapper``/``Reducer`` interfaces, ``Map`` and its identity, the typed
record ops ``ValueMap`` (``map``) and ``Rekey`` (``fold_by``), the
key-sorted :class:`GroupedView`, the
associative-fold reducer behind ``ARReduce.reduce``, and the map-side
combiner descriptor.  Joins, stream reducers, fused (composed) mappers
and the batched-UDF lowering of record ops are later slices.
"""

import numpy as np

from .ops import segment


class Mapper(object):
    """Lowest-level map interface: consume whole datasets, yield (k, v)."""

    #: map_blocks prefers the bounded iter_byte_blocks scan.
    streams_bytes = False

    def map(self, *datasets):
        raise NotImplementedError()


def _identity(k, v):
    """The no-op record map (checkpoint/sink heads)."""
    yield k, v


def _one_input(datasets):
    if len(datasets) != 1:
        raise ValueError("this mapper consumes exactly one input")
    return datasets[0]


class Map(Mapper):
    """Wraps a generator function ``f(k, v) -> iterable[(k, v)]``."""

    def __init__(self, mapper):
        self.mapper = mapper

    def map(self, *datasets):
        return self.stream(_one_input(datasets).read())

    def stream(self, kvs):
        mapper = self.mapper
        for key, value in kvs:
            for nkv in mapper(key, value):
                yield nkv

    def __repr__(self):
        return "Map[{}]".format(getattr(self.mapper, "__name__",
                                        type(self.mapper)))


class RecordOp(Mapper):
    """A typed per-record transform (``stream`` maps a record iterator)."""

    def map(self, *datasets):
        return self.stream(_one_input(datasets).read())


class ValueMap(RecordOp):
    """value -> f(value)  (PMap.map)."""

    def __init__(self, f):
        self.f = f

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, f(v)

    def __repr__(self):
        return "ValueMap[{}]".format(getattr(self.f, "__name__", self.f))


class Rekey(RecordOp):
    """(k, v) -> (key_f(v), value_f(v)): the re-key of a_group_by."""

    def __init__(self, key_f, value_f=None):
        self.key_f = key_f
        self.value_f = value_f

    def stream(self, kvs):
        key_f, value_f = self.key_f, self.value_f
        if value_f is None:
            for _k, v in kvs:
                yield key_f(v), v
        else:
            for _k, v in kvs:
                yield key_f(v), value_f(v)

    def __repr__(self):
        return "Rekey[{}]".format(getattr(self.key_f, "__name__", self.key_f))


class GroupedView(object):
    """Key-sorted grouped view over one partition's blocks: hash-sort,
    collision repair, then groups ordered by real key (uncomparable mixed
    keys keep hash order)."""

    def __init__(self, blocks):
        from .blocks import Block

        self._groups = segment.sort_and_group(Block.concat(blocks))
        starts = self._groups.starts
        self._order = np.arange(len(starts))
        if len(starts):
            try:
                self._order = np.argsort(
                    self._groups.block.keys.take(starts), kind="stable")
            except TypeError:
                pass

    def sorted_groups(self):
        return self._groups

    def key_order(self):
        return self._order


class Reducer(object):
    """Consumes one grouped view per input; yields (k, v) records."""

    def reduce(self, *datasets):
        raise NotImplementedError()


class AssocFoldReducer(Reducer):
    """Final fold of an associative reduce: recognized ops (sum/min/max)
    fold over the sorted groups with the segment folds, opaque binops fold
    on host.  Emits (k, (k, acc)) in key order."""

    def __init__(self, op):
        self.op = segment.as_assoc_op(op)

    def reduce(self, *datasets):
        from .blocks import pylist

        view = datasets[0]
        folded = segment.fold_sorted(view.sorted_groups(), self.op)
        keys = pylist(folded.keys)
        vals = pylist(folded.values)
        for gi in view.key_order():
            k = keys[gi]
            yield k, (k, vals[gi])


class PartialReduceCombiner(object):
    """Fold records sharing a key with an associative op during the map
    stage, before the shuffle."""

    def __init__(self, op):
        self.op = segment.as_assoc_op(op)
