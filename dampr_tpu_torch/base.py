"""Mapper / reducer building blocks of the DSL.

Port of ``dampr_tpu/base.py``: the
``Mapper``/``Streamable``/``Reducer`` interfaces, ``Map`` and its
identity, composition (``ComposedStreamable``, ``ComposedMapper``,
:func:`fuse`), the typed record ops with their batch lowering
(``ValueMap``, ``MapValues``, ``MapKeys``, ``Prefix``, ``Suffix``,
``Filter``, ``FlatMap``, ``Rekey``, ``Sample``, ``Inspect``;
:func:`record_op_chain`), ``Splitter``, the lifecycle and whole-partition operators
(``BlockMapper``, ``StreamMapper``, ``BlockReducer``, ``StreamReducer``,
``Reduce``), the map-side crosses (``MapCrossJoin``, ``MapAllJoin``), the
sort-merge joins, the key-sorted :class:`GroupedView`, the out-of-core
:class:`StreamingGroupedView` and :func:`streaming_merge_join` (groups in
hash order), the associative-fold reducer behind ``ARReduce.reduce`` and
the map-side combiner descriptor.

The runner clones an operator per job (``copy.deepcopy``).  Lifecycle
operators and unknown user subclasses are copied, so concurrent jobs never
share their state; the stateless wrappers share themselves through
:func:`_shared_instance_deepcopy`, so a user callable is never descended
into unless it is a callable *object* with instance state.
"""

import copy
import functools
import itertools
import logging
import threading
import types

import numpy as np

from .ops import hashing, segment

log = logging.getLogger("dampr_tpu_torch.base")


class Splitter(object):
    """Partition routing of one key by its hash lanes, so it agrees with
    ``Block.partition_ids``."""

    def partition(self, key, n_partitions):
        h1, _ = hashing.hash_keys([key])
        return int(h1[0] % np.uint32(n_partitions))

#: Callables always safe to share by reference: plain functions, builtins
#: and classes deep-copy atomically, and a closure's captured state is the
#: user's explicit choice.  Bound methods are not here: deepcopy copies
#: their ``__self__``.
_ATOMIC_CALLABLE_TYPES = (types.FunctionType, types.BuiltinFunctionType,
                          types.BuiltinMethodType, type)

_share_warned = set()
_share_warned_lock = threading.Lock()


def _stateful_callable(v, _depth=0):
    """Is ``v`` a callable *object* with per-instance state (held
    directly, in a ``functools.partial``, as a bound method's receiver, or
    one or two levels down a list/tuple/dict)?  Shared across concurrent
    jobs it would see every partition's records interleaved, so the
    per-job clone copies it instead."""
    if _depth > 2:
        return False
    if isinstance(v, functools.partial):
        return (_stateful_callable(v.func, _depth + 1)
                or any(_stateful_callable(a, _depth + 1) for a in v.args)
                or any(_stateful_callable(a, _depth + 1)
                       for a in (v.keywords or {}).values()))
    if isinstance(v, (list, tuple)):
        return any(_stateful_callable(x, _depth + 1) for x in v)
    if isinstance(v, dict):
        return any(_stateful_callable(x, _depth + 1) for x in v.values())
    if isinstance(v, types.MethodType):
        recv = v.__self__
        if isinstance(recv, type):
            return False  # classmethod: class-level state, always shared
        return bool(getattr(recv, "__dict__", None))
    if not callable(v) or isinstance(v, _ATOMIC_CALLABLE_TYPES):
        return False
    return bool(getattr(v, "__dict__", None))


def _shared_instance_deepcopy(self, memo):
    """``__deepcopy__`` of the stateless wrapper operators: the per-job
    clone shares the instance unless it holds a stateful callable object,
    which is then deep-copied so each job gets its own.  State that
    resists deepcopy (files, sockets, locks) keeps the shared instance,
    with a once-per-type warning: it must then be thread-safe."""
    held = getattr(self, "__dict__", None) or {}
    if not any(_stateful_callable(v) for v in held.values()):
        return self
    pre_keys = set(memo)
    try:
        cls = self.__class__
        clone = cls.__new__(cls)
        memo[id(self)] = clone
        for k, v in held.items():
            object.__setattr__(clone, k, copy.deepcopy(v, memo))
        return clone
    except Exception as e:  # noqa: BLE001 - any copy failure shares
        # Drop every memo entry this attempt added (children may point at
        # the discarded clone), then map self to the shared original.
        for k in set(memo) - pre_keys:
            if k != id(memo):
                memo.pop(k, None)
        memo[id(self)] = self
        key = type(self).__name__
        with _share_warned_lock:
            seen = key in _share_warned
            _share_warned.add(key)
        if not seen:
            log.warning("%s holds a stateful callable object whose state "
                        "cannot be deep-copied (%s); the instance is SHARED "
                        "across concurrent jobs and must be thread-safe",
                        key, e)
        return self


class Mapper(object):
    """Lowest-level map interface: consume whole datasets, yield (k, v)."""

    #: map_blocks prefers the bounded iter_byte_blocks scan.
    streams_bytes = False

    def map(self, *datasets):
        raise NotImplementedError()


class Streamable(object):
    """Per-record transform of a (k, v) iterator."""

    def stream(self, kvs):
        raise NotImplementedError()


def _identity(k, v):
    """The no-op record map (checkpoint/sink heads)."""
    yield k, v


def _one_input(datasets):
    if len(datasets) != 1:
        raise ValueError("this mapper consumes exactly one input")
    return datasets[0]


class Map(Mapper, Streamable):
    """Wraps a generator function ``f(k, v) -> iterable[(k, v)]``."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, mapper):
        if isinstance(mapper, Mapper):
            raise TypeError("Map wraps a function, not a Mapper")
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


class ComposedStreamable(Streamable):
    """Two Streamables chained: ``right`` streams ``left``'s output."""

    def __init__(self, left, right):
        if not isinstance(left, Streamable) or not isinstance(right,
                                                              Streamable):
            raise TypeError("ComposedStreamable takes two Streamables")
        self.left = left
        self.right = right

    def stream(self, kvs):
        return self.right.stream(self.left.stream(kvs))


class ComposedMapper(Mapper):
    """A Mapper whose output streams through a Streamable (a fused stage,
    or ``custom_mapper`` driving a bare Streamable)."""

    def __init__(self, left, right):
        if not isinstance(left, Mapper) or not isinstance(right, Streamable):
            raise TypeError("ComposedMapper takes a Mapper and a Streamable")
        self.left = left
        self.right = right

    def map(self, *datasets):
        return self.right.stream(self.left.map(*datasets))


def fuse(aggs):
    """Compose a list of Streamables into one Mapper (map fusion: a chain
    of record ops costs one pass)."""
    if len(aggs) == 1:
        return aggs[0]
    s = aggs[1]
    for agg in aggs[2:]:
        s = ComposedStreamable(s, agg)
    return ComposedMapper(aggs[0], s)


def is_pure_record_stream(m):
    """True when a (possibly fused) mapper chains only plain ``Map`` and
    ``RecordOp`` steps, so records transform independently; False for
    anything with per-chunk semantics (a ``StreamMapper`` sees a whole
    partition, a ``BlockMapper`` has a per-chunk lifecycle)."""
    if type(m) is Map or isinstance(m, RecordOp):
        return True
    if type(m) in (ComposedMapper, ComposedStreamable):
        return is_pure_record_stream(m.left) and is_pure_record_stream(m.right)
    return False


# ---------------------------------------------------------------------------
# Typed record ops: per-record transforms with a batch lowering
# ---------------------------------------------------------------------------

class RecordOp(Mapper, Streamable):
    """A typed per-record transform.  ``apply_batch(keys, values) ->
    (keys, values)`` runs it over parallel lists in one tight loop per op
    per batch; ``stream`` is the record-at-a-time lowering.

    A fused generator chain interleaves the ops per record; the batch
    lowering runs op 1 over the whole batch first.  Each op still sees
    records in stream order, so a self-contained stateful UDF (a dedupe
    filter's seen-set) behaves the same either way; only state shared
    across two ops of one chain could tell, and the batch size bounds
    that.  Clones share the wrapper unless it holds a stateful callable
    object (:func:`_shared_instance_deepcopy`)."""

    __deepcopy__ = _shared_instance_deepcopy

    def map(self, *datasets):
        return self.stream(_one_input(datasets).read())

    def apply_batch(self, ks, vs):
        raise NotImplementedError()


def _fn_name(f):
    return getattr(f, "__name__", f)


class ValueMap(RecordOp):
    """value -> f(value)  (PMap.map)."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        f = self.f
        return ks, [f(v) for v in vs]

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, f(v)

    def __repr__(self):
        return "ValueMap[{}]".format(_fn_name(self.f))


class MapValues(RecordOp):
    """(a, b) -> (a, f(b))  (PMap.map_values)."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        f = self.f
        return ks, [(v[0], f(v[1])) for v in vs]

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, (v[0], f(v[1]))


class MapKeys(RecordOp):
    """(a, b) -> (f(a), b)  (PMap.map_keys)."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        f = self.f
        return ks, [(f(v[0]), v[1]) for v in vs]

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, (f(v[0]), v[1])


class Prefix(RecordOp):
    """value -> (f(value), value)."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        f = self.f
        return ks, [(f(v), v) for v in vs]

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, (f(v), v)


class Suffix(RecordOp):
    """value -> (value, f(value))."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        f = self.f
        return ks, [(v, f(v)) for v in vs]

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            yield k, (v, f(v))


class Filter(RecordOp):
    """Keep records whose value satisfies the predicate."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        sel = list(map(self.f, vs))
        if all(sel):
            return ks, vs
        return (list(itertools.compress(ks, sel)),
                list(itertools.compress(vs, sel)))

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            if f(v):
                yield k, v

    def __repr__(self):
        return "Filter[{}]".format(_fn_name(self.f))


class FlatMap(RecordOp):
    """value -> iterable, flattened; the key repeats per emitted element,
    in the input's order."""

    def __init__(self, f):
        self.f = f

    def apply_batch(self, ks, vs):
        repeat = itertools.repeat
        f = self.f
        nks, nvs = [], []
        ext_k, ext_v = nks.extend, nvs.extend
        for k, v in zip(ks, vs):
            out = f(v)
            if not isinstance(out, (list, tuple)):
                out = list(out)
            ext_v(out)
            ext_k(repeat(k, len(out)))
        return nks, nvs

    def stream(self, kvs):
        f = self.f
        for k, v in kvs:
            for vi in f(v):
                yield k, vi

    def __repr__(self):
        return "FlatMap[{}]".format(_fn_name(self.f))


class Rekey(RecordOp):
    """(k, v) -> (key_f(v), value_f(v)): the re-key of group_by,
    a_group_by and sort_by."""

    def __init__(self, key_f, value_f=None):
        self.key_f = key_f
        self.value_f = value_f

    def apply_batch(self, ks, vs):
        key_f, value_f = self.key_f, self.value_f
        nks = [key_f(v) for v in vs]
        return nks, (vs if value_f is None else [value_f(v) for v in vs])

    def stream(self, kvs):
        key_f, value_f = self.key_f, self.value_f
        if value_f is None:
            for _k, v in kvs:
                yield key_f(v), v
        else:
            for _k, v in kvs:
                yield key_f(v), value_f(v)

    def __repr__(self):
        return "Rekey[{}]".format(_fn_name(self.key_f))


class Sample(RecordOp):
    """Keep each record with probability ``prob``.  Draws come from the
    thread-local RNG that ``rand_factory`` returns, one per record in
    stream order, so both lowerings consume the same random sequence."""

    def __init__(self, prob, rand_factory):
        self.prob = prob
        self.rand_factory = rand_factory

    def apply_batch(self, ks, vs):
        rnd = self.rand_factory().random
        prob = self.prob
        sel = [rnd() < prob for _ in vs]
        return ([k for k, s in zip(ks, sel) if s],
                [v for v, s in zip(vs, sel) if s])

    def stream(self, kvs):
        rnd = self.rand_factory().random
        prob = self.prob
        for k, v in kvs:
            if rnd() < prob:
                yield k, v


class Inspect(RecordOp):
    """Debug pass-through: print each value as it streams."""

    def __init__(self, prefix=""):
        self.prefix = prefix

    def apply_batch(self, ks, vs):
        for v in vs:
            print("{}: {}".format(self.prefix, v))
        return ks, vs

    def stream(self, kvs):
        for k, v in kvs:
            print("{}: {}".format(self.prefix, v))
            yield k, v


def record_op_chain(m):
    """A (possibly fused) mapper as its ordered list of RecordOps, or None
    when a link has no batch lowering.  ``Map(_identity)`` links drop
    out."""
    out = []

    def walk(node):
        if isinstance(node, RecordOp):
            out.append(node)
            return True
        if type(node) is Map and node.mapper is _identity:
            return True
        if type(node) in (ComposedMapper, ComposedStreamable):
            return walk(node.left) and walk(node.right)
        return False

    return out if walk(m) else None


class BlockMapper(Mapper, Streamable):
    """start/add/finish lifecycle mapper, stateful across one chunk (the
    runner deep-copies it per job)."""

    def start(self):
        pass

    def add(self, key, value):
        raise NotImplementedError()

    def finish(self):
        return ()

    def map(self, *datasets):
        return self.stream(_one_input(datasets).read())

    def stream(self, kvs):
        self.start()
        for key, value in kvs:
            for out in self.add(key, value):
                yield out
        for out in self.finish():
            yield out


class StreamMapper(Mapper, Streamable):
    """Whole-chunk generator mapper: ``f(value_iter) -> iterable[(k, v)]``
    (runs on empty chunks too)."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, streamer_f):
        self.streamer_f = streamer_f

    def map(self, *datasets):
        return self.stream(_one_input(datasets).read())

    def stream(self, kvs):
        return self.streamer_f(v for _k, v in kvs)


def group_datasets(dataset):
    """A chunker or a list of datasets -> one readable dataset."""
    from .dataset import CatDataset, Chunker, EmptyDataset

    if isinstance(dataset, Chunker) and not hasattr(dataset, "read"):
        dataset = list(dataset.chunks())
    if isinstance(dataset, (list, tuple)):
        if len(dataset) > 1:
            return CatDataset(dataset)
        if len(dataset) == 1:
            return dataset[0]
        return EmptyDataset()
    return dataset


def _two_inputs(datasets):
    if len(datasets) != 2:
        raise ValueError("this operator consumes exactly two inputs")
    return datasets


class MapCrossJoin(Mapper):
    """Map-side cross product of the primary chunk with the whole other
    input: ``crosser(k1, v1, k2, v2)`` per pair, primary-major.  With
    ``cache`` the other side is read once and held in RAM (broadcast
    join)."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, crosser, cache=False):
        self.crosser = crosser
        self.cache = cache

    def map(self, *datasets):
        left, right = [group_datasets(d) for d in _two_inputs(datasets)]
        if self.cache:
            cached = list(right.read())
            read_right = lambda: iter(cached)  # noqa: E731
        else:
            read_right = right.read
        crosser = self.crosser
        for key, value in left.read():
            for key2, value2 in read_right():
                for kv in crosser(key, value, key2, value2):
                    yield kv


class MapAllJoin(Mapper):
    """Loads the whole other input through ``load_f`` and passes it to
    every primary record: ``crosser(k, v, loaded)``."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, crosser, load_f=lambda d: [v for _k, v in d]):
        self.crosser = crosser
        self.load_f = load_f

    def map(self, *datasets):
        left, right = [group_datasets(d) for d in _two_inputs(datasets)]
        loaded = self.load_f(right.read())
        crosser = self.crosser
        for key, value in left.read():
            for kv in crosser(key, value, loaded):
                yield kv


class StreamingGroupedView(object):
    """Out-of-core grouped view: a k-way merge over hash-sorted runs,
    holding one bounded window per run instead of the whole partition.

    Groups stream in **hash order**, not key order (key order would need
    the whole partition).  Records that share a 64-bit hash sub-group
    exactly by their real key.  Windows read back from disk carry their
    hash lanes, so nothing is hashed again."""

    def __init__(self, refs):
        self.refs = refs

    def _run_stream(self, ref, run_idx):
        from .blocks import pylist

        for window in ref.iter_windows():
            h1, h2 = window.hashes()
            for a, b, k, v in zip(h1.tolist(), h2.tolist(),
                                  pylist(window.keys), pylist(window.values)):
                yield (a, b, run_idx, k, v)

    def _merged(self):
        import heapq

        streams = [self._run_stream(ref, i)
                   for i, ref in enumerate(self.refs)]
        return heapq.merge(*streams, key=lambda r: (r[0], r[1], r[2]))

    def grouped_read(self):
        """``(key, value_iter)`` per group, groupby-style: advancing to the
        next group drains the previous iterator.  A hash group's values
        stream lazily (a hot key never buffers); only records of *other*
        keys colliding in the same 64-bit hash are set aside and grouped
        exactly after it."""
        merged = self._merged()
        rec = next(merged, None)
        holder = [None]
        while rec is not None:
            h = (rec[0], rec[1])
            key = rec[3]
            pending = []  # same-hash records of other keys (collisions)

            def values(first=rec, h=h, key=key, pending=pending):
                yield first[4]
                while True:
                    r = next(merged, None)
                    if r is None or (r[0], r[1]) != h:
                        holder[0] = r
                        return
                    if r[3] == key:
                        yield r[4]
                    else:
                        pending.append(r)

            gen = values()
            holder[0] = None
            yield key, gen
            for _ in gen:  # drain what the caller left unconsumed
                pass
            for k2, vs2 in _group_small(pending):
                yield k2, iter(vs2)
            rec = holder[0]

    def read(self):
        for k, vs in self.grouped_read():
            for v in vs:
                yield k, v


def _group_small(records):
    """Exact first-seen-order grouping of a handful of collision records."""
    by_key = []
    for rec in records:
        for entry in by_key:
            if entry[0] == rec[3]:
                entry[1].append(rec[4])
                break
        else:
            by_key.append((rec[3], [rec[4]]))
    return by_key


def _hash_bundles(view):
    """``(h64 pair, [(key, [values])])`` per distinct hash of a
    StreamingGroupedView, in hash order.  Values materialize per hash
    group, so a streaming join's memory bound is its largest join-key
    group."""
    for h, group in itertools.groupby(view._merged(),
                                      key=lambda r: (r[0], r[1])):
        yield h, _group_small(group)


def streaming_merge_join(lview, rview, reducer):
    """Out-of-core sort-merge join over two hash-ordered streaming views
    (the runner's over-budget path for co-partitioned joins): both sides
    walk by 64-bit hash, and real keys match inside each hash, so
    collisions join exactly.  Inner/left/outer semantics and ``many``
    come from the reducer; yields the ``(k, (k, v))`` records of the
    Keyed* joins."""
    left_only = isinstance(reducer, (LeftJoin, OuterJoin))
    right_only = isinstance(reducer, OuterJoin)
    inner_many = getattr(reducer, "many", False)
    joiner = reducer.joiner_f
    default = getattr(reducer, "default", lambda: iter(()))

    def emit(k, result, flatten):
        if flatten:
            for v in result:
                yield k, (k, v)
        else:
            yield k, (k, result)

    def left_emit(groups):
        if left_only:
            for k, vals in groups:
                for out in emit(k, joiner(k, iter(vals), default()), False):
                    yield out

    def right_emit(groups):
        if right_only:
            for k, vals in groups:
                for out in emit(k, joiner(k, default(), iter(vals)), False):
                    yield out

    lgen = _hash_bundles(lview)
    rgen = _hash_bundles(rview)
    lcur = next(lgen, None)
    rcur = next(rgen, None)
    while lcur is not None and rcur is not None:
        if lcur[0] < rcur[0]:
            for out in left_emit(lcur[1]):
                yield out
            lcur = next(lgen, None)
        elif lcur[0] > rcur[0]:
            for out in right_emit(rcur[1]):
                yield out
            rcur = next(rgen, None)
        else:
            # the same 64-bit hash: match by real key (collision-exact)
            rgroups = rcur[1]
            matched_r = [False] * len(rgroups)
            for k, lvals in lcur[1]:
                hit = None
                for j, (rk, _rvals) in enumerate(rgroups):
                    if rk == k:
                        hit = j
                        break
                if hit is not None:
                    matched_r[hit] = True
                    result = joiner(k, iter(lvals), iter(rgroups[hit][1]))
                    for out in emit(k, result, inner_many):
                        yield out
                else:
                    for out in left_emit([(k, lvals)]):
                        yield out
            for j, (rk, rvals) in enumerate(rgroups):
                if not matched_r[j]:
                    for out in right_emit([(rk, rvals)]):
                        yield out
            lcur = next(lgen, None)
            rcur = next(rgen, None)
    while lcur is not None:
        for out in left_emit(lcur[1]):
            yield out
        lcur = next(lgen, None)
    while rcur is not None:
        for out in right_emit(rcur[1]):
            yield out
        rcur = next(rgen, None)


class GroupedView(object):
    """Key-sorted grouped view over one input's blocks within a partition:
    hash-sort, collision repair, then groups ordered by real key
    (uncomparable mixed keys keep hash order).  ``grouped_read()`` yields
    ``(key, value_iter)`` in that order; within a group, values keep the
    order of the partition's blocks."""

    def __init__(self, blocks):
        from .blocks import Block

        self._groups = segment.sort_and_group(Block.concat(blocks))
        self._starts, self._ends = self._groups.bounds()
        self._order = np.arange(len(self._starts))
        if len(self._starts):
            try:
                self._order = np.argsort(
                    self._groups.block.keys.take(self._starts),
                    kind="stable")
            except TypeError:
                pass

    @property
    def n_groups(self):
        return len(self._starts)

    def grouped_read(self):
        from .blocks import pylist

        keys = self._groups.block.keys
        vals = self._groups.block.values

        def group_values(s, e, _W=8192):
            # boxed a window at a time: a hot key never boxes its whole
            # group at once
            for w0 in range(s, e, _W):
                for v in pylist(vals[w0:min(e, w0 + _W)]):
                    yield v

        for gi in self._order:
            s, e = int(self._starts[gi]), int(self._ends[gi])
            k = keys[s]
            yield (k.item() if isinstance(k, np.generic) else k,
                   group_values(s, e))

    def read(self):
        for k, vs in self.grouped_read():
            for v in vs:
                yield k, v

    # Segment-fold accessors (AssocFoldReducer) ----------------------------
    def sorted_groups(self):
        return self._groups

    def key_order(self):
        return self._order


class Reducer(object):
    """Consumes one grouped view per input; yields (k, v) records."""

    def reduce(self, *datasets):
        raise NotImplementedError()

    def yield_groups(self, dataset):
        return dataset.grouped_read()


class Reduce(Reducer):
    """``f(key, value_iter) -> value`` per group."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, reducer):
        self.reducer = reducer

    def reduce(self, *datasets):
        reducer = self.reducer
        for k, vs in self.yield_groups(_one_input(datasets)):
            yield k, reducer(k, vs)


class KeyedReduce(Reduce):
    """Reduce whose emitted value is the ``(k, v)`` pair itself."""

    def reduce(self, *datasets):
        for k, v in super(KeyedReduce, self).reduce(*datasets):
            yield k, (k, v)


class BlockReducer(Reducer):
    """start/add/finish lifecycle over one partition's groups (deep-copied
    per partition job)."""

    def start(self):
        pass

    def add(self, k, it):
        raise NotImplementedError()

    def finish(self):
        return ()

    def reduce(self, *datasets):
        self.start()
        for k, vs in self.yield_groups(_one_input(datasets)):
            for nkv in self.add(k, vs):
                yield nkv
        for nkv in self.finish():
            yield nkv


class StreamReducer(Reducer):
    """``f(group_iter) -> iterable[(k, v)]`` over a whole partition, values
    wrapped as ``(k, v)`` pairs.  Runs on empty partitions too."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, stream_f):
        self.stream_f = stream_f

    def reduce(self, *datasets):
        for nk, nv in self.stream_f(self.yield_groups(_one_input(datasets))):
            yield nk, (nk, nv)


class AssocFoldReducer(Reducer):
    """Final fold of an associative reduce: recognized ops (sum/min/max)
    fold over the sorted groups with the segment folds, opaque binops fold
    on host; emits (k, (k, acc)) in key order.  Over a streaming view the
    groups fold one at a time with the op's function, in hash order."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, op):
        self.op = segment.as_assoc_op(op)

    def reduce(self, *datasets):
        from .blocks import pylist

        view = _one_input(datasets)
        if not isinstance(view, GroupedView):
            fn = self.op.fn
            for k, vs in view.grouped_read():
                acc = None
                first = True
                for v in vs:
                    acc = v if first else fn(acc, v)
                    first = False
                yield k, (k, acc)
            return
        folded = segment.fold_sorted(view.sorted_groups(), self.op)
        keys = pylist(folded.keys)
        vals = pylist(folded.values)
        for gi in view.key_order():
            k = keys[gi]
            yield k, (k, vals[gi])


def _sort_merge_walk(g1, g2):
    """The sort-merge walk every join shares: ``('both', k, lvals,
    rvals)`` on matched keys, ``('left', k, lvals)`` / ``('right', k,
    rvals)`` on exclusives, in ascending key order."""
    left, right = next(g1, None), next(g2, None)
    while left is not None and right is not None:
        if left[0] < right[0]:
            yield ("left", left[0], left[1])
            left = next(g1, None)
        elif left[0] > right[0]:
            yield ("right", right[0], right[1])
            right = next(g2, None)
        else:
            yield ("both", left[0], left[1], right[1])
            left, right = next(g1, None), next(g2, None)
    while left is not None:
        yield ("left", left[0], left[1])
        left = next(g1, None)
    while right is not None:
        yield ("right", right[0], right[1])
        right = next(g2, None)


class _Join(Reducer):
    """Sort-merge join over two co-partitioned grouped views.  Sides the
    join keeps (``sides``) with no match see ``default()`` for the
    missing one."""

    __deepcopy__ = _shared_instance_deepcopy

    sides = ()

    def __init__(self, joiner_f, default=lambda: iter(())):
        self.joiner_f = joiner_f
        self.default = default

    def _joined(self, datasets):
        left, right = _two_inputs(datasets)
        walk = _sort_merge_walk(self.yield_groups(left),
                                self.yield_groups(right))
        for side, k, *vals in walk:
            if side == "both":
                yield k, self.joiner_f(k, vals[0], vals[1])
            elif side not in self.sides:
                continue
            elif side == "left":
                yield k, self.joiner_f(k, vals[0], self.default())
            else:
                yield k, self.joiner_f(k, self.default(), vals[0])

    def reduce(self, *datasets):
        return self._joined(datasets)


class InnerJoin(_Join):
    """Sort-merge inner join; ``many=True`` flattens each match's
    iterable into separate records."""

    def __init__(self, joiner_f, many=False):
        super(InnerJoin, self).__init__(joiner_f)
        self.many = many

    def reduce(self, *datasets):
        for k, out in self._joined(datasets):
            for nv in (out if self.many else (out,)):
                yield k, nv


class LeftJoin(_Join):
    """Sort-merge left join; unmatched left groups see ``default()``."""

    sides = ("left",)


class OuterJoin(_Join):
    """Sort-merge full outer join; either missing side sees
    ``default()``."""

    sides = ("left", "right")


class KeyedInnerJoin(InnerJoin):
    def reduce(self, *datasets):
        for k, v in super(KeyedInnerJoin, self).reduce(*datasets):
            yield k, (k, v)


class KeyedLeftJoin(LeftJoin):
    def reduce(self, *datasets):
        for k, v in super(KeyedLeftJoin, self).reduce(*datasets):
            yield k, (k, v)


class KeyedOuterJoin(OuterJoin):
    def reduce(self, *datasets):
        for k, v in super(KeyedOuterJoin, self).reduce(*datasets):
            yield k, (k, v)


class PartialReduceCombiner(object):
    """Fold records sharing a key with an associative op during the map
    stage, before the shuffle."""

    def __init__(self, op):
        self.op = segment.as_assoc_op(op)
