"""Logical lazy DAG (port of ``dampr_tpu/graph.py``).

A copy-on-write stage list: every ``add_*`` returns ``(Source, new_graph)``
with the receiver unmodified; ``union`` merges two graphs deduping shared
stages; construction order is the schedule.
"""

import itertools


class Source(object):
    """Handle naming the output of one stage (process-unique id)."""

    _ids = itertools.count()

    __slots__ = ("sid",)

    def __init__(self):
        self.sid = next(Source._ids)

    def __hash__(self):
        return hash(self.sid)

    def __eq__(self, other):
        return isinstance(other, Source) and self.sid == other.sid

    def __lt__(self, other):
        return self.sid < other.sid

    def __repr__(self):
        return "Source[{}]".format(self.sid)


class StageNode(object):
    """Base for stage nodes; ``options`` carries per-op settings (binop,
    exec_target, ...).  ``_provenance`` is set on a node the plan fused:
    the descriptions of the stages it was built from."""

    __slots__ = ("inputs", "output", "options", "_provenance")

    def __init__(self, inputs, output, options=None):
        self.inputs = list(inputs)
        self.output = output
        self.options = options or {}
        self._provenance = None


class GInput(StageNode):
    """Binds a Source to an input tap."""

    __slots__ = ("tap",)

    def __init__(self, tap, output):
        super(GInput, self).__init__([], output)
        self.tap = tap

    def __repr__(self):
        return "GInput[{} <- {!r}]".format(self.output, self.tap)


class GMap(StageNode):
    """Map stage: mapper plus an optional map-side combiner."""

    __slots__ = ("mapper", "combiner")

    def __init__(self, inputs, output, mapper, combiner=None, options=None):
        super(GMap, self).__init__(inputs, output, options)
        self.mapper = mapper
        self.combiner = combiner

    def __repr__(self):
        return "GMap[{} <- {}]".format(self.output, self.inputs)


class GReduce(StageNode):
    """Reduce stage over co-partitioned inputs."""

    __slots__ = ("reducer",)

    def __init__(self, inputs, output, reducer, options=None):
        super(GReduce, self).__init__(inputs, output, options)
        self.reducer = reducer

    def __repr__(self):
        return "GReduce[{} <- {}]".format(self.output, self.inputs)


class GSink(StageNode):
    """Durable text output stage."""

    __slots__ = ("sinker", "path")

    def __init__(self, inputs, output, sinker, path, options=None):
        super(GSink, self).__init__(inputs, output, options)
        self.sinker = sinker
        self.path = path

    def __repr__(self):
        return "GSink[{} <- {} -> {}]".format(self.output, self.inputs,
                                              self.path)


class Graph(object):
    """Copy-on-write stage list."""

    def __init__(self, stages=None):
        self.stages = list(stages) if stages else []

    def _extend(self, node):
        g = Graph(self.stages)
        g.stages.append(node)
        return node.output, g

    def add_input(self, tap):
        return self._extend(GInput(tap, Source()))

    def add_mapper(self, inputs, mapper, combiner=None, options=None):
        return self._extend(GMap(inputs, Source(), mapper, combiner, options))

    def add_reducer(self, inputs, reducer, options=None):
        return self._extend(GReduce(inputs, Source(), reducer, options))

    def add_sink(self, inputs, sinker, path, options=None):
        return self._extend(GSink(inputs, Source(), sinker, path, options))

    def union(self, other):
        """Merge two graphs, deduping shared nodes by output Source."""
        seen = set()
        stages = []
        for node in itertools.chain(self.stages, other.stages):
            if node.output not in seen:
                seen.add(node.output)
                stages.append(node)
        return Graph(stages)

    def __repr__(self):
        return "Graph[{} stages]".format(len(self.stages))
