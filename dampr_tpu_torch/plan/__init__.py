"""The plan step between graph construction and the runner.

Reduced port of ``dampr_tpu/plan``: :mod:`.passes` rewrites the graph
(dead stages, map fusion, combiner hoisting, sink fusion), the
device-lowering pass (:mod:`.lower`) picks each executed stage's target,
and the static analyzer (:mod:`..analyze`, ``settings.analyze``) reports
on the stages that will execute.
The cost model, ``explain()``, pipelined edges and stage reuse are later
slices.  Every rewrite is value-semantic: shared stage nodes are never
mutated.
"""

from .. import settings
from . import ir, lower, passes


def prepare(graph, outputs, runner=None):
    """The executed graph for ``outputs`` and its plan report: the rules
    that fired (``rules``, ``fused``, ``dead``), the stage counts before
    and after (``stages_before``, ``stages_after``), the lowering, and
    the count of device handoff edges (``handoff_edges``; ``runner``, when
    given, is told which stages produce them), and the ``analysis``
    section."""
    graph, report = passes.optimize(graph, outputs)
    graph, lowering = lower.apply(graph, outputs, runner=runner)
    report["lowering"] = lowering
    report["device_stages"] = lowering["device_stages"]
    report["handoff_edges"] = sum(1 for e in lowering["handoff"]
                                  if e["handoff"] == "device")
    # Static analysis: per-stage purity/determinism verdicts and coded
    # diagnostics over the stage list that will execute.  Bytecode-only
    # here; the pickle and associativity probes run from validate() and
    # the linter.
    from ..analyze import validate as _av

    if settings.analyze:
        try:
            report["analysis"] = _av.report_section(
                graph, probe_traceable=settings.lower_enabled())
        except Exception:  # noqa: BLE001 - analysis never fails a run
            report["analysis"] = _av.empty_section()
    else:
        report["analysis"] = _av.empty_section()
    return graph, report
