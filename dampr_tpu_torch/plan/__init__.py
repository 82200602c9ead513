"""The plan step between graph construction and the runner.

Reduced port of ``dampr_tpu/plan``: the one rewrite this slice's path
needs, **combiner hoisting** (an identity stage that only carries a
map-side combiner folds into its producing map, so map-side combine runs
inside the producer's jobs, as ``dampr_tpu/plan/passes.py`` does), then
the device-lowering pass (:mod:`.lower`).  Map fusion, sink fusion,
dead-stage elimination, the cost model and ``explain()`` are later slices.
Every rewrite is value-semantic: shared stage nodes are never mutated.
"""

from ..graph import GMap, Graph
from . import ir, lower


def hoist_combiners(graph, outputs=()):
    """Fold each identity+combiner stage into the map that produces its
    input, when that map has no combiner of its own and feeds nothing
    else (and its output is not requested).  Returns ``(graph', n)``."""
    stages = list(graph.stages)
    hoisted = 0
    for i, stage in enumerate(stages):
        if (stage is None or not isinstance(stage, GMap)
                or len(stage.inputs) != 1 or not ir.has_combiner(stage)
                or not ir.is_identity_mapper(stage.mapper)):
            continue
        src = stage.inputs[0]
        if src in outputs:
            continue
        pi = next((j for j, p in enumerate(stages[:i])
                   if p is not None and p.output == src), None)
        if pi is None:
            continue
        prod = stages[pi]
        consumers = [s for s in stages
                     if s is not None and src in s.inputs]
        if (not isinstance(prod, GMap) or ir.has_combiner(prod)
                or len(consumers) != 1):
            continue
        opts = dict(prod.options or {})
        if "binop" in stage.options:
            opts["binop"] = stage.options["binop"]
        stages[pi] = GMap(prod.inputs, stage.output, prod.mapper,
                          stage.combiner, opts)
        stages[i] = None
        hoisted += 1
    if not hoisted:
        return graph, 0
    return Graph([s for s in stages if s is not None]), hoisted


def prepare(graph, outputs):
    """The executed graph for ``outputs`` and its plan report."""
    graph, hoisted = hoist_combiners(graph, outputs)
    graph, lowering = lower.apply(graph, outputs)
    return graph, {"hoisted_combiners": hoisted, "lowering": lowering,
                   "device_stages": lowering["device_stages"]}
