"""The plan step between graph construction and the runner.

Port of ``dampr_tpu/plan``:

- :mod:`.passes` rewrites the graph (dead stages, map fusion, combiner
  hoisting, sink fusion);
- :mod:`.cost` sizes a named run from its run history (partition count,
  per-stage ``batch_size`` and ``n_reducers``), and the learned cost
  model (:mod:`.model`) may override the partition count;
- :mod:`.lower` picks each executed stage's target, which device edges
  keep their counts on the card (priced against the spill path over the
  run's history), and which redistributions ride the mesh exchange;
- :mod:`.pipeline` marks the stage edges the runner may stream;
- the static analyzer (:mod:`..analyze`, ``settings.analyze``) reports on
  the stages that will execute;
- :mod:`.explain` renders all of it (``PBase.explain()``);
- :mod:`.reuse`, the cross-run cache, decides per stage at run start
  whether a published output mounts, re-runs over appended files only, or
  recomputes (``stats()["reuse"]``).

The report records the executed plan's stage shapes, so the next run
under the same name can match its plan against this run's measurements.
Every rewrite is value-semantic: shared stage nodes are never mutated.
"""

import time

from .. import settings
from . import cost, explain, ir, lower, passes, pipeline
from .explain import explain_text
from .ir import graph_signature

__all__ = ["prepare", "empty_report", "explain_text", "graph_signature",
           "ir", "passes", "cost", "explain", "lower", "pipeline"]


def _analysis_section(graph):
    """The ``analysis`` section: bytecode-only verdicts and coded
    diagnostics over the stages that will execute (the pickle and
    associativity probes run from ``validate()`` and the linter)."""
    from ..analyze import validate as _av

    if not settings.analyze:
        return _av.empty_section()
    try:
        return _av.report_section(graph,
                                  probe_traceable=settings.lower_enabled())
    except Exception:  # noqa: BLE001 - analysis never fails a run
        return _av.empty_section()


def empty_report(graph):
    """The report of a plan that never ran, with every section."""
    from ..analyze import validate as _av

    report = passes.empty_report(graph)
    report.update({
        "enabled": False,
        "adaptive": {"applied": False, "reason": "disabled"},
        "cost": cost.empty_cost_section("plan not prepared"),
        "lowering": {"enabled": False, "targets": [], "device_stages": 0,
                     "handoff": []},
        "device_stages": 0,
        "handoff_edges": 0,
        "shuffle": lower.empty_shuffle_section(False),
        "pipeline": pipeline.empty_section(settings.pipeline_enabled()),
        "analysis": _av.empty_section(),
        "stage_shapes": ir.stage_shapes(graph),
        "seconds": 0.0,
    })
    return report


def prepare(graph, outputs, runner=None):
    """The executed graph for ``outputs`` and its plan report, in the JAX
    package's order: the rewrite passes (``rules``, ``fused``, ``dead``,
    ``stages_before``/``stages_after``), history-driven sizing
    (``adaptive``) and the cost model (``cost``), which set
    ``runner.n_partitions`` and per-stage options, the lowering with its
    handoff edges (``lowering``, ``device_stages``, ``handoff_edges``;
    ``runner._handoff_sids``), the shuffle routing (``shuffle``;
    ``runner._shuffle_targets``), the streamed edges (``pipeline``;
    ``runner._pipeline_edges``), the ``analysis`` section and the
    executed ``stage_shapes``.  Without a runner the sizing layers have no
    run name, so no history."""
    t0 = time.perf_counter()
    graph, report = passes.optimize(graph, outputs)
    report["enabled"] = True
    if runner is not None:
        runner.graph = graph
    cost.adapt(runner, graph, report)
    cost.apply_model(runner, graph, report)
    if runner is not None:
        graph = runner.graph
    graph, lowering = lower.apply(graph, outputs, runner=runner)
    report["lowering"] = lowering
    report["device_stages"] = lowering["device_stages"]
    report["handoff_edges"] = sum(1 for e in lowering["handoff"]
                                  if e["handoff"] == "device")
    report["shuffle"] = lower.apply_shuffle(graph, lowering, runner=runner)
    pipeline.apply(runner, graph, outputs, report)
    report["analysis"] = _analysis_section(graph)
    report["stage_shapes"] = ir.stage_shapes(graph)
    report["seconds"] = round(time.perf_counter() - t0, 6)
    return graph, report
