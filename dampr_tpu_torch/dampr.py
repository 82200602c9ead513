"""The fluent DSL: lazy, value-semantic pipeline construction.

Port of the part of ``dampr_tpu/dampr.py`` the slice's path uses:
``Dampr.text``/``read_input``, ``PMap.custom_mapper``/``map``/
``fold_values``/``fold_by``/``sink``/``sink_tsv``, ``ARReduce.reduce``,
``PBase.run``/``read``, ``ValueEmitter`` and ``RunStats``.  Handles are
immutable: every op returns a new handle over a copied graph; results read
back key-sorted.
"""

import random

from .base import (AssocFoldReducer, Map, Mapper, PartialReduceCombiner,
                   Rekey, ValueMap, _identity)
from .graph import Graph, Source
from .inputs import PathInput
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

    def map(self, f):
        """Map each value through ``f``."""
        return self._add_mapper(ValueMap(f))

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

    def custom_mapper(self, mapper, name=None, **options):
        """Install a Mapper instance as its own stage; ``lower=False`` in
        the options keeps it off the device."""
        if not isinstance(mapper, Mapper):
            raise TypeError("custom_mapper takes a Mapper instance")
        return self._add_mapper(mapper, options=options or None)

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


class Dampr(object):
    """Entry point: source constructors."""

    def __init__(self, graph=None, runner=None):
        self.graph = Graph() if graph is None else graph
        self.runner = MTRunner if runner is None else runner

    @classmethod
    def read_input(cls, dataset):
        """Read from a dataset / chunker directly."""
        source, ng = Graph().add_input(dataset)
        return PMap(source, cls(ng))

    @classmethod
    def text(cls, fname, chunk_size=16 * 1024 ** 2, followlinks=False):
        """Newline-delimited text from a file/dir/glob, split into byte
        range chunks."""
        return cls.read_input(PathInput(fname, chunk_size, followlinks))

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
