"""The fluent DSL: lazy, value-semantic pipeline construction.

Port of ``dampr_tpu/dampr.py`` without the ``explain``/``submit``/resume
surfaces: the sources (``Dampr.text``/``json``/
``memory``/``urls``/``read_input``/``from_dataset``),
the per-record ops (``map``, ``map_values``, ``map_keys``, ``prefix``,
``suffix``, ``filter``, ``flat_map``, ``sample``, ``inspect``), the
associative folds (``fold_by``, ``a_group_by`` -> ``reduce``/``sum``/
``first``, ``count``, ``mean``), ``sort_by``, ``topk``, ``group_by`` ->
:class:`PReduce`, ``len()``, the custom operators, the joins
(:class:`PJoin`) and map-side crosses, ``checkpoint``/``cached``, the
sinks, single- and multi-output runs, and ``validate()`` (the static
analyzer's diagnostics, :mod:`.analyze`).

Every chained call is its own stage node; the plan (:mod:`.plan`) fuses
chains of per-record stages into one executed map stage at ``run()``
time, and ``checkpoint()`` is the barrier it never fuses across.
Handles are immutable: every op returns a new handle over a copied
graph; results read back key-sorted.
"""

import itertools
import json
import logging
import random
import sys
import threading
import weakref

from . import settings
from .base import (AssocFoldReducer, ComposedMapper, Filter, FlatMap,
                   Inspect, KeyedInnerJoin, KeyedLeftJoin, KeyedOuterJoin,
                   KeyedReduce, Map, MapAllJoin, MapCrossJoin, MapKeys,
                   MapValues, Mapper, PartialReduceCombiner, Prefix, Reducer,
                   Rekey, Sample, StreamMapper, StreamReducer, Streamable,
                   Suffix, ValueMap, _identity, _one_input,
                   _shared_instance_deepcopy)
from .dataset import CatDataset, Chunker
from .graph import GMap, Graph, Source
from .inputs import MemoryInput, PathInput, UrlsInput
from .ops import segment
from .runner import MTRunner


class RunStats(list):
    """Per-stage dicts that are also callable: ``stats()`` returns the run
    summary, the ``stats.json`` payload (:mod:`.obs`): stages, devtime,
    spill/merge totals, the device counters and kernel launches, the plan,
    and the trace files of a traced run."""

    def __init__(self, stages=(), summary=None):
        super(RunStats, self).__init__(stages)
        self.summary = summary if summary is not None else {}

    def __call__(self):
        return self.summary

    @property
    def trace_file(self):
        """Path of the run's Chrome trace-event JSON (None untraced)."""
        return self.summary.get("trace_file")

    @property
    def stats_file(self):
        """Path of the persisted stats.json (None untraced)."""
        return self.summary.get("stats_file")


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

    def __iter__(self):
        return self.stream()

    def delete(self):
        self.dataset.delete()


#: Every live pipeline handle (weakly held).  The linter
#: (:mod:`.analyze.lint`) discovers through it the pipelines a linted
#: module constructed at import time, without running anything; the DSL
#: itself never reads it.
_live_handles = weakref.WeakSet()


class PBase(object):
    def __init__(self, source, pmer):
        if not isinstance(source, Source):
            raise TypeError("source must be a graph Source")
        self.source = source
        self.pmer = pmer
        _live_handles.add(self)

    def run(self, name=None, **kwargs):
        """Evaluate the graph; returns a ValueEmitter whose ``stats``
        carries the run's metrics."""
        if name is None:
            name = "dampr/{}".format(random.random())
        if settings.seed is not None:
            _reset_sample_rngs()
        runner = self.pmer.runner(name, self.pmer.graph, **kwargs)
        ds = runner.run([self.source])
        em = ValueEmitter(ds[0])
        em.stats = RunStats([s.as_dict() for s in runner.stats],
                            runner.run_summary)
        return em

    def validate(self, resume=False, num_processes=1, probe=True):
        """Pre-flight diagnostics for this pipeline, WITHOUT executing
        anything: the ordered diagnostic list
        (:class:`dampr_tpu_torch.analyze.Diagnostic`, errors first; empty
        = clean).  Runs the full probe set — serialization, randomized
        associativity, traceability — regardless of ``settings.analyze``:
        an explicit call is its own opt-in.  ``num_processes > 1``
        promotes unpicklable captures to errors; ``probe=False`` keeps it
        to the fast bytecode-only classification.  ``resume=True`` (the
        checkpoint fingerprint check) raises: the port has no resume
        fingerprints yet."""
        from .analyze import validate as _av

        return _av.validate_graph(
            self.pmer.graph, resume=resume,
            num_processes=num_processes, probe_traceable=probe,
            probe_assoc=probe, probe_pickle=probe)

    def read(self, k=None, **kwargs):
        """Shorthand for run() + read()."""
        return self.run(**kwargs).read(k)


class _TopKBlocks(Mapper):
    """A chunk's top-k candidates: numeric 1D value lanes select with one
    ``np.argpartition`` per block, then the per-block winners merge
    through ``nlargest``; anything else streams through ``nlargest`` over
    ``(x, x)`` pairs.  Either way the candidates are ``(1, (x, x))``."""

    __deepcopy__ = _shared_instance_deepcopy

    def __init__(self, k):
        self.k = k

    def map(self, *datasets):
        import heapq

        import numpy as np

        from .blocks import pylist

        ds = _one_input(datasets)
        k = self.k
        if k <= 0:
            return
        if hasattr(ds, "iter_blocks"):
            blocks = [b for b in ds.iter_blocks() if len(b)]
            if all(b.values.dtype != object and b.values.ndim == 1
                   for b in blocks):
                cands = []
                for b in blocks:
                    v = b.values
                    if len(v) > k:
                        v = v[np.argpartition(v, len(v) - k)[len(v) - k:]]
                    cands.extend((x, x) for x in pylist(v))
                for p in heapq.nlargest(k, cands):
                    yield 1, p
                return
        it = (v for _k, v in ds.read())
        for p in heapq.nlargest(k, ((x, x) for x in it)):
            yield 1, p


class PMap(PBase):
    """A lazy collection; every chained op is its own stage node (the plan
    fuses per-record chains at run time)."""

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

    def checkpoint(self, force=False, combiner=None, options=None):
        """An explicit materialization barrier: the stage's output is
        computed at this boundary and the plan never fuses across it
        (``options["barrier"]``).  ``force`` is accepted for API
        compatibility (every checkpoint materializes)."""
        opts = dict(options) if options else {}
        opts.setdefault("barrier", True)
        source, pmer = self.pmer._add_mapper([self.source], Map(_identity),
                                             combiner=combiner, options=opts)
        return PMap(source, pmer)

    def cached(self, **options):
        """Materialize this stage's output and pin it in RAM (it never
        spills)."""
        options["memory"] = True
        return self.checkpoint(force=True, options=options)

    # -- per-record ops: typed RecordOps, run a batch at a time ------------
    def map(self, f):
        """Map each value through ``f``."""
        return self._add_mapper(ValueMap(f))

    def map_values(self, f):
        """Map the second element of two-tuple values."""
        return self._add_mapper(MapValues(f))

    def map_keys(self, f):
        """Map the first element of two-tuple values."""
        return self._add_mapper(MapKeys(f))

    def prefix(self, f):
        """value -> (f(value), value)."""
        return self._add_mapper(Prefix(f))

    def suffix(self, f):
        """value -> (value, f(value))."""
        return self._add_mapper(Suffix(f))

    def filter(self, f):
        """Keep the values for which ``f`` holds."""
        return self._add_mapper(Filter(f))

    def flat_map(self, f):
        """Map each value to an iterable and flatten."""
        return self._add_mapper(FlatMap(f))

    def sample(self, prob):
        """Keep each record with probability ``prob``."""
        if not 0 <= prob <= 1.0:
            raise ValueError("sample probability must lie in [0, 1]")
        return self._add_mapper(Sample(prob, _get_rand))

    def inspect(self, prefix="", exit=False):
        """Print records as they stream through (a debug pass-through);
        ``exit=True`` runs up to here and exits."""
        ins = self._add_mapper(Inspect(prefix))
        if exit:
            ins.run()
            sys.exit(0)
        return ins

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

    def sort_by(self, key, **options):
        """Sort values globally by ``key``: the final read is key-sorted.
        The re-key is a plain map stage, so per-record ops after it fuse
        with it."""
        return self._add_mapper(Rekey(key), options=options or None)

    def count(self, key=lambda x: x, **options):
        """Count values per key (a segment sum)."""
        return self.a_group_by(key, lambda v: 1).reduce(segment.SUM,
                                                        **options)

    def mean(self, key=lambda x: 1, value=lambda x: x, **options):
        """Per-key mean.  The (sum, count) pair is the value: int or float
        values build a 2D lane that ``PAIR_SUM`` folds in one vectorized
        pass; anything else folds pairwise on host."""
        def _pair(v):
            x = value(v)
            # the count takes the value's lane type, so the pair stays
            # type-uniform (a (float, int) tuple would be an object lane)
            return (x, 1.0) if type(x) is float else (x, 1)

        def _avg(x):
            return (x[0], x[1][0] / float(x[1][1]))

        return (self.a_group_by(key, _pair)
                .reduce(segment.PAIR_SUM, **options)
                .map(_avg))

    def topk(self, k, value=None):
        """The ``k`` largest values by ``value`` (the value itself by
        default), ordered by the (sort key, value) pair.  Each chunk
        offers its candidates; one partition reduce merges them."""
        import heapq

        vf = value

        def _cands(values):
            pairs = (((x, x) for x in values) if vf is None
                     else ((vf(x), x) for x in values))
            return ((1, p) for p in heapq.nlargest(k, pairs))

        def _select(groups):
            cands = (p for _one, ps in groups for p in ps)
            return ((p[1], 1) for p in heapq.nlargest(k, cands))

        if vf is None:
            head = self.custom_mapper(_TopKBlocks(k))
        else:
            head = self.partition_map(_cands)
        return head.partition_reduce(_select).map(lambda x: x[0])

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

    def sink_json(self, path):
        """JSON-serialize values, one a line, then sink."""
        return self.map(json.dumps).sink(path)


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

    def first(self, **options):
        """The first value seen per key."""
        return self.reduce(segment.FIRST, **options)

    def sum(self, **options):
        """Sum the values per key (a segment sum for numeric values)."""
        return self.reduce(segment.SUM, **options)


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
    def json(cls, *args, **kwargs):
        """Line-delimited JSON records."""
        return cls.text(*args, **kwargs).map(json.loads)

    @classmethod
    def urls(cls, urls, skip_on_error=True):
        """Newline-delimited text over HTTP, one chunk per URL."""
        return cls.read_input(UrlsInput(urls, skip_on_error))

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
        if settings.seed is not None:
            _reset_sample_rngs()
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


# sample()'s per-thread RNG: jobs run on threads, and one shared Random
# would serialize them on its lock and interleave their draws.  With
# settings.seed set, each thread's RNG derives from (seed, the thread's
# index in this run), re-derived at every run start, so a serial run
# reproduces exactly and a parallel one per thread stream.  Without a
# seed, each thread's RNG seeds from the OS.
_RAND_LOCAL = threading.local()
_RAND_LOCK = threading.Lock()
_RAND_STATE = {"epoch": 0, "next_index": None}


def _reset_sample_rngs():
    """Start a new RNG generation: every thread re-seeds from (seed,
    index within the run) at its next draw."""
    with _RAND_LOCK:
        _RAND_STATE["epoch"] += 1
        _RAND_STATE["next_index"] = itertools.count()


def _get_rand():
    seed = settings.seed
    st = _RAND_LOCAL
    if seed is None:
        r = getattr(st, "rand", None)
        if r is None or getattr(st, "seeded", False):
            r = random.Random()
            st.rand, st.seeded = r, False
        return r
    epoch = _RAND_STATE["epoch"]
    if (getattr(st, "epoch", None) != epoch
            or not getattr(st, "seeded", False)):
        with _RAND_LOCK:
            counter = _RAND_STATE["next_index"]
            if counter is None:  # a seeded draw before any run
                counter = _RAND_STATE["next_index"] = itertools.count()
            idx = next(counter)
        st.rand = random.Random(seed * 1000003 + idx * 7919)
        st.epoch, st.seeded = epoch, True
    return st.rand


def setup_logging(debug=False):
    level = logging.DEBUG if debug else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")
