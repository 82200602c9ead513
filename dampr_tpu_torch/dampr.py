"""The fluent DSL: lazy, value-semantic pipeline construction.

Port of ``dampr_tpu/dampr.py`` without the per-record RecordOps
(``map_values``, ``filter``, ``flat_map``, ``count``, ``mean``,
``sort_by``, ``topk``, ...), ``checkpoint``/``cached`` and the URL,
JSON, ``explain``/``validate``/``submit`` surfaces: the sources
(``Dampr.text``/``memory``/``read_input``/``from_dataset``), ``map``,
the associative folds, ``group_by`` -> :class:`PReduce`, ``len()``, the
custom operators, the joins (:class:`PJoin`) and map-side crosses, the
sinks, and single- and multi-output runs.  Handles are immutable: every
op returns a new handle over a copied graph; results read back
key-sorted.
"""

import random

from .base import (AssocFoldReducer, ComposedMapper, KeyedInnerJoin,
                   KeyedLeftJoin, KeyedOuterJoin, KeyedReduce, Map,
                   MapAllJoin, MapCrossJoin, Mapper, PartialReduceCombiner,
                   Reducer, Rekey, StreamMapper, StreamReducer, Streamable,
                   ValueMap, _identity)
from .dataset import CatDataset, Chunker
from .graph import GMap, Graph, Source
from .inputs import MemoryInput, PathInput
from .ops import segment
from .runner import MTRunner


class RunStats(list):
    """Per-stage dicts that are also callable: ``stats()`` returns the run
    summary (stages, plan, device counters, kernel launches)."""

    def __init__(self, stages=(), summary=None):
        super(RunStats, self).__init__(stages)
        self.summary = summary if summary is not None else {}

    def __call__(self):
        return self.summary


class ValueEmitter(object):
    """Reads values from a completed run."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.stats = RunStats()

    def stream(self):
        for _k, v in self.dataset.read():
            yield v

    def read(self, k=None):
        out = []
        for v in self.stream():
            if k is not None and len(out) >= k:
                break
            out.append(v)
        return out

    def delete(self):
        self.dataset.delete()


class PBase(object):
    def __init__(self, source, pmer):
        if not isinstance(source, Source):
            raise TypeError("source must be a graph Source")
        self.source = source
        self.pmer = pmer

    def run(self, name=None, **kwargs):
        """Evaluate the graph; returns a ValueEmitter whose ``stats``
        carries the run's metrics."""
        if name is None:
            name = "dampr/{}".format(random.random())
        runner = self.pmer.runner(name, self.pmer.graph, **kwargs)
        ds = runner.run([self.source])
        em = ValueEmitter(ds[0])
        em.stats = RunStats([s.as_dict() for s in runner.stats],
                            runner.run_summary)
        return em

    def read(self, k=None, **kwargs):
        """Shorthand for run() + read()."""
        return self.run(**kwargs).read(k)


class PMap(PBase):
    """A lazy collection; every chained op is its own stage node."""

    def _add_mapper(self, mapper, options=None):
        source, pmer = self.pmer._add_mapper([self.source], mapper,
                                             options=options)
        return PMap(source, pmer)

    def _materialized_for_reduce(self):
        """A handle whose source a reduce may consume directly.  A map
        stage's output is hash-routed (and hash-sorted when a reduce reads
        it) by construction; taps, sinks and reduce outputs get an
        identity map first (a reduce output is registered under its
        input's partition ids with the keys its reducer emitted, so it is
        not routed by those keys)."""
        for stage in self.pmer.graph.stages:
            if stage.output == self.source:
                if isinstance(stage, GMap):
                    return self
                break
        return self._add_mapper(Map(_identity))

    def map(self, f):
        """Map each value through ``f``."""
        return self._add_mapper(ValueMap(f))

    def group_by(self, key, vf=None):
        """General (non-associative) grouping; returns a PReduce.  ``vf``
        defaults to the identity."""
        pm = self._add_mapper(Rekey(key, vf))
        return PReduce(pm.source, pm.pmer)

    def a_group_by(self, key, vf=None):
        """Associative grouping (map-side combine before the shuffle)."""
        return ARReduce(self._add_mapper(Rekey(key, vf)))

    def fold_by(self, key, binop, value=lambda x: x, **options):
        """Shortcut for ``a_group_by(key, value).reduce(binop)``."""
        return self.a_group_by(key, value).reduce(binop, **options)

    def fold_values(self, binop, **options):
        """Fold values by each record's existing key (no re-key pass):
        scanner blocks keep their cached hash lanes and numeric counts."""
        return ARReduce(self).reduce(binop, **options)

    def len(self):
        """Count the collection's records, as a one-value collection.  The
        map never touches records: text chunks count their newlines,
        block-backed chunks sum block lengths (``CountRecords``)."""
        def _sum_counts(groups):
            totals = [c for _k, cs in groups for c in cs]
            return ((1, sum(totals)),) if totals else ()

        from .ops.text import CountRecords

        return (self.custom_mapper(CountRecords())
                .partition_reduce(_sum_counts)
                .map(lambda x: x[1]))

    def custom_mapper(self, mapper, name=None, **options):
        """Install a Mapper instance as its own stage (a bare Streamable is
        driven over the stage's input); ``lower=False`` in the options
        keeps it off the device."""
        if isinstance(mapper, Streamable) and not isinstance(mapper, Mapper):
            mapper = ComposedMapper(Map(_identity), mapper)
        if not isinstance(mapper, Mapper):
            raise TypeError("custom_mapper takes a Mapper or a Streamable")
        return self._add_mapper(mapper, options=options or None)

    def custom_reducer(self, reducer, name=None, **options):
        """Install a Reducer instance as its own stage."""
        if not isinstance(reducer, Reducer):
            raise TypeError("custom_reducer takes a Reducer instance")
        me = self._materialized_for_reduce()
        source, pmer = me.pmer._add_reducer([me.source], reducer,
                                            options=options or None)
        return PMap(source, pmer)

    def partition_map(self, f, **options):
        """Map a whole chunk's value iterator (runs on empty chunks)."""
        return self.custom_mapper(StreamMapper(f), **options)

    def partition_reduce(self, f):
        """Reduce a whole partition's group iterator (runs on empty
        partitions)."""
        return self.custom_reducer(StreamReducer(f))

    # -- two-input ops -----------------------------------------------------
    def join(self, other):
        """Co-partitioned join with another collection; returns a
        PJoin."""
        if not isinstance(other, PBase):
            raise TypeError("join takes a collection")
        me = self._materialized_for_reduce()
        if isinstance(other, PMap):
            other = other._materialized_for_reduce()
        pmer = Dampr(me.pmer.graph.union(other.pmer.graph), me.pmer.runner)
        return PJoin(me.source, pmer, other.source)

    def cross_right(self, other, cross, memory=False):
        """Map-side cross product, ``cross(x, y)`` for x here and y in
        ``other``; this side is the iterated one."""
        if not isinstance(other, PMap):
            raise TypeError("cross_right takes a PMap")
        return other.cross_left(self, lambda xi, yi: cross(yi, xi), memory)

    def cross_left(self, other, cross, memory=False, **options):
        """Map-side cross product (broadcast join), ``cross(x, y)`` for x
        here and y in ``other``; ``other`` is the iterated side and this
        one is read whole for each of its chunks (``memory=True`` reads it
        once per chunk and holds it in RAM)."""
        def _cross(k1, v1, k2, v2):
            yield k1, cross(v2, v1)

        pmer = Dampr(self.pmer.graph.union(other.pmer.graph),
                     self.pmer.runner)
        source, pmer = pmer._add_mapper(
            [other.source, self.source], MapCrossJoin(_cross, cache=memory),
            options=options or None)
        return PMap(source, pmer)

    def cross_set(self, other, cross, agg=None, **options):
        """Load the whole of this side through ``agg`` (default ``list``)
        and call ``cross(y, loaded)`` for every record y of ``other``."""
        def _cross(k1, v1, loaded):
            yield k1, cross(v1, loaded)

        agg = list if agg is None else agg

        def _aggregate(kvs):
            return agg(v for _k, v in kvs)

        pmer = Dampr(self.pmer.graph.union(other.pmer.graph),
                     self.pmer.runner)
        source, pmer = pmer._add_mapper(
            [other.source, self.source], MapAllJoin(_cross, _aggregate),
            options=options or None)
        return PMap(source, pmer)

    def sink(self, path):
        """Write each value as a text line into part files under ``path``."""
        source, pmer = self.pmer._add_sink([self.source], Map(_identity),
                                           path=path)
        return PMap(source, pmer)

    def sink_tsv(self, path):
        """Tab-join tuple values, then sink."""
        return self.map(lambda x: u"\t".join(str(p) for p in x)).sink(path)


class ARReduce(object):
    """Associative reduce handle: fold map-side, shuffle the partials,
    fold again reduce-side."""

    def __init__(self, pmap):
        self.pmap = pmap

    def reduce(self, binop, reduce_buffer=1000, **options):
        """Reduce groups with an associative binop.  Plants an identity
        stage carrying the map-side combiner (the plan hoists it into the
        producer) ahead of the final-fold reduce."""
        op = segment.as_assoc_op(binop)
        options.update({"binop": op, "reduce_buffer": reduce_buffer})
        source, pmer = self.pmap.pmer._add_mapper(
            [self.pmap.source], Map(_identity),
            combiner=PartialReduceCombiner(op), options=options)
        new_source, pmer = pmer._add_reducer(
            [source], AssocFoldReducer(op), options=options)
        return PMap(new_source, pmer)


def _pair_lists(left, right):
    """A bare join's default aggregate: both sides' values as lists."""
    return list(left), list(right)


class PReduce(PBase):
    """A grouped collection (after ``group_by``)."""

    def reduce(self, f):
        """``f(key, value_iter) -> value`` per group; values read back as
        ``(key, value)``."""
        source, pmer = self.pmer._add_reducer([self.source], KeyedReduce(f))
        return PMap(source, pmer)

    def unique(self, key=lambda x: x):
        """Distinct values per group (first occurrence wins)."""
        def _uniq(k, it):
            seen = set()
            agg = []
            for v in it:
                fv = key(v)
                if fv not in seen:
                    seen.add(fv)
                    agg.append(v)
            return agg

        return self.reduce(_uniq)

    def join(self, other):
        """Join the groups with another collection; returns a PJoin."""
        if not isinstance(other, PBase):
            raise TypeError("join takes a collection")
        if isinstance(other, PMap):
            other = other._materialized_for_reduce()
        pmer = Dampr(self.pmer.graph.union(other.pmer.graph),
                     self.pmer.runner)
        return PJoin(self.source, pmer, other.source)

    def partition_reduce(self, f):
        """Reduce a whole partition's group iterator (runs on empty
        partitions)."""
        source, pmer = self.pmer._add_reducer([self.source],
                                              StreamReducer(f))
        return PMap(source, pmer)


class PJoin(PBase):
    """Join handle over two co-partitioned grouped sources.  Run bare, it
    pairs each matched key's value lists."""

    def __init__(self, source, pmer, right):
        super(PJoin, self).__init__(source, pmer)
        self.right = right

    def run(self, name=None, **kwargs):
        return self.reduce(_pair_lists).run(name, **kwargs)

    def _join(self, reducer):
        source, pmer = self.pmer._add_reducer([self.source, self.right],
                                              reducer)
        return PMap(source, pmer)

    def reduce(self, aggregate, many=False):
        """Inner join: ``aggregate(left_iter, right_iter)`` per matched
        key; ``many=True`` flattens its result into separate records."""
        return self._join(KeyedInnerJoin(
            lambda k, left, right: aggregate(left, right), many))

    def left_reduce(self, aggregate):
        """Left join: a key missing on the right sees an empty
        iterator."""
        return self._join(KeyedLeftJoin(
            lambda k, left, right: aggregate(left, right)))

    def outer_reduce(self, aggregate):
        """Full outer join: whichever side lacks a key sees an empty
        iterator."""
        return self._join(KeyedOuterJoin(
            lambda k, left, right: aggregate(left, right)))


class Dampr(object):
    """Entry point: source constructors and the multi-output run."""

    def __init__(self, graph=None, runner=None):
        self.graph = Graph() if graph is None else graph
        self.runner = MTRunner if runner is None else runner

    @classmethod
    def memory(cls, items, partitions=50):
        """An in-memory collection (keys are positions), cut into about
        ``partitions`` chunks."""
        return cls.read_input(MemoryInput(list(enumerate(items)),
                                          partitions))

    @classmethod
    def read_input(cls, *datasets):
        """Read from datasets / chunkers directly; several datasets are
        one chunk each."""
        ds = datasets[0] if len(datasets) == 1 else CatDataset(datasets)
        source, ng = Graph().add_input(ds)
        return PMap(source, cls(ng))

    @classmethod
    def from_dataset(cls, dataset):
        """Wrap a Dataset or Chunker (a custom subclass, or raw stage
        outputs) as an input."""
        if not isinstance(dataset, Chunker):
            raise TypeError("from_dataset takes a Chunker")
        return cls.read_input(dataset)

    @classmethod
    def text(cls, fname, chunk_size=16 * 1024 ** 2, followlinks=False):
        """Newline-delimited text from a file/dir/glob, split into byte
        range chunks."""
        return cls.read_input(PathInput(fname, chunk_size, followlinks))

    @classmethod
    def run(cls, *pmers, **kwargs):
        """Run several collections in one pass (shared stages run once);
        returns one ValueEmitter per argument, sharing the run's stats."""
        if not pmers:
            raise ValueError("Dampr.run needs at least one collection")
        sources = []
        graph = None
        for pm in pmers:
            if isinstance(pm, PJoin):
                pm = pm.reduce(_pair_lists)
            graph = (pm.pmer.graph if graph is None
                     else pm.pmer.graph.union(graph))
            sources.append(pm.source)
        name = kwargs.pop("name", None) or "dampr/{}".format(random.random())
        runner = pm.pmer.runner(name, graph, **kwargs)
        datasets = runner.run(sources)
        stats = RunStats([s.as_dict() for s in runner.stats],
                         runner.run_summary)
        emitters = []
        for ds in datasets:
            em = ValueEmitter(ds)
            em.stats = stats
            emitters.append(em)
        return emitters

    def _add_mapper(self, inputs, mapper, combiner=None, options=None):
        output, ng = self.graph.add_mapper(inputs, mapper, combiner,
                                           options)
        return output, Dampr(ng, self.runner)

    def _add_reducer(self, inputs, reducer, options=None):
        output, ng = self.graph.add_reducer(inputs, reducer, options)
        return output, Dampr(ng, self.runner)

    def _add_sink(self, inputs, sinker, path):
        output, ng = self.graph.add_sink(inputs, sinker, path)
        return output, Dampr(ng, self.runner)
