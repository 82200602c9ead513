"""The plan step between graph construction and the runner.

Reduced port of ``dampr_tpu/plan``: :mod:`.passes` rewrites the graph
(dead stages, map fusion, combiner hoisting, sink fusion), then the
device-lowering pass (:mod:`.lower`) picks each executed stage's target.
The cost model, ``explain()``, pipelined edges and stage reuse are later
slices.  Every rewrite is value-semantic: shared stage nodes are never
mutated.
"""

from . import ir, lower, passes


def prepare(graph, outputs, runner=None):
    """The executed graph for ``outputs`` and its plan report: the rules
    that fired (``rules``, ``fused``, ``dead``), the stage counts before
    and after (``stages_before``, ``stages_after``), the lowering, and
    the count of device handoff edges (``handoff_edges``; ``runner``, when
    given, is told which stages produce them)."""
    graph, report = passes.optimize(graph, outputs)
    graph, lowering = lower.apply(graph, outputs, runner=runner)
    report["lowering"] = lowering
    report["device_stages"] = lowering["device_stages"]
    report["handoff_edges"] = sum(1 for e in lowering["handoff"]
                                  if e["handoff"] == "device")
    return graph, report
