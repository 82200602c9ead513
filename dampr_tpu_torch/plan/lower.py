"""The device-lowering pass: assign each executed stage a target.

Port of ``dampr_tpu/plan/lower.py`` (``analyze``, ``handoff_analyze``
and ``apply``; history-driven placement and shuffle routing are later
slices):

- a **map** stage lowers when its chain is a numeric ``map``/``filter``
  chain the static analyzer certifies (:mod:`..analyze.torchtrace`,
  ``settings.analyze``): the runner runs it as one lane program, checked
  per batch against the host's 64-bit evaluation.  Otherwise it lowers
  when the head of its (possibly fused) mapper chain is a native-vocabulary
  scanner
  (:func:`dampr_tpu_torch.ops.lower.claims`) and the rest of the chain is
  identity, its map-side combiner (if any) is a ``sum``, and every
  consumer of its output (through bare checkpoints) folds it with a keyed
  ``sum``.  The device
  program emits partial counts per batch where the host scanner emits them
  per window; only a summing consumer is invariant to that regrouping.
- a **reduce** stage lowers when it is an associative ``sum``/``min``/
  ``max`` fold (the device segment folds, exact-lane gated per block).

Lowered stages get ``options["exec_target"] = "device"`` on a fresh clone;
the decisions with their reasons land in the plan report's ``lowering``
section.  Master switch: ``settings.lower``.  Each edge from a lowered
map into a lowered fold may then keep its counts on the device
(:func:`handoff_analyze`, ``settings.handoff``).
"""

from .. import base, settings
from ..graph import GMap, GReduce
from . import ir


def _fold_kind(stage):
    """The combiner kind a stage carries, or None."""
    op = None
    if isinstance(getattr(stage, "combiner", None),
                  base.PartialReduceCombiner):
        op = stage.combiner.op
    elif "binop" in (stage.options or {}):
        from ..ops import segment

        op = segment.as_assoc_op(stage.options["binop"])
    return getattr(op, "kind", None)


def _consumers_all_sum_folds(graph, output, protected, _depth=0):
    """Does every consumer of ``output`` (looking through bare
    checkpoints) fold it with a keyed associative ``sum``?  A requested
    output (``protected``) is read directly and so never qualifies."""
    if _depth > len(graph.stages) or output in protected:
        return False
    consumers = [s for s in graph.stages
                 if output in getattr(s, "inputs", ())]
    if not consumers:
        return False
    for stage in consumers:
        if isinstance(stage, GReduce):
            red = getattr(stage, "reducer", None)
            if (isinstance(red, base.AssocFoldReducer)
                    and red.op.kind == "sum"):
                continue
            return False
        if isinstance(stage, GMap) and ir.is_identity_mapper(stage.mapper):
            kind = _fold_kind(stage)
            if kind == "sum":
                continue
            if kind is None and not ir.has_combiner(stage) and \
                    _consumers_all_sum_folds(graph, stage.output, protected,
                                             _depth + 1):
                continue  # a bare checkpoint: its consumers decide
            return False
        return False
    return True


def _map_decision(stage, graph, protected):
    from ..ops import lower as ops_lower

    if (stage.options or {}).get("lower") is False:
        return "host", "killed by stage option lower=False"
    if len(stage.inputs) != 1:
        return "host", "multi-input map (join shapes stay host)"
    leaves = ir.flatten_mapper(stage.mapper)
    head, tail = leaves[0], leaves[1:]
    if ops_lower.claims(head) is None:
        # A chain the static analyzer certifies (pure deterministic
        # ValueMap/Filter lane ops, an optional trailing Rekey, each
        # traced on meta tensors) lowers as a vectorized lane program,
        # exactness-gated per batch at dispatch.  Its record multiplicity
        # and grouping equal the host path's, so no combiner or consumer
        # granularity constraint applies.
        if settings.analyze:
            from ..analyze import torchtrace

            spec, why = torchtrace.chain_claims(stage.mapper)
            if spec is not None:
                return "device", why + " (verified-per-block lane program)"
        return "host", "no device lowering for {} (opaque UDF)".format(
            ir.part_name(head))
    bad = [p for p in tail if not ir.is_identity_mapper(p)]
    if bad:
        return "host", "post-scan ops not in the device vocabulary: " + \
            ", ".join(ir.part_name(p) for p in bad)
    kind = _fold_kind(stage)
    if ir.has_combiner(stage) and kind != "sum":
        return "host", "combiner kind {!r} not sum — partial-count " \
            "granularity would be observable".format(kind)
    if kind != "sum" and not _consumers_all_sum_folds(
            graph, stage.output, protected):
        return "host", "not every consumer is a keyed sum fold — " \
            "partial-count granularity would be observable"
    return "device", "scanner {} + keyed sum fold run the token-fold " \
        "program".format(type(head).__name__)


def _reduce_decision(stage):
    if (stage.options or {}).get("lower") is False:
        return "host", "killed by stage option lower=False"
    red = getattr(stage, "reducer", None)
    if not isinstance(red, base.AssocFoldReducer):
        name = ir.part_name(red) if red is not None else "?"
        return "host", "non-associative reducer {} (opaque UDF)".format(name)
    if red.op.kind not in ("sum", "min", "max"):
        return "host", "fold binop has no device kind (opaque Python binop)"
    return "device", "assoc {} fold runs the device segment folds " \
        "(exact-lane gate per block)".format(red.op.kind)


def analyze(graph, outputs=()):
    """Per-executed-stage decisions: [{sid, kind, target, reason}]."""
    protected = set(outputs)
    decisions = []
    for sid, stage in enumerate(graph.stages):
        kind = ir.stage_kind(stage)
        if kind == "input":
            continue
        if kind == "map":
            target, reason = _map_decision(stage, graph, protected)
        elif kind == "reduce":
            target, reason = _reduce_decision(stage)
        else:
            target, reason = "host", "sinks write through the host"
        decisions.append({"sid": sid, "kind": kind, "target": target,
                          "reason": reason})
    return decisions


def handoff_analyze(graph, decisions):
    """Per edge out of a lowered map: may its counts stay on the device
    into the consumer (``handoff="device"``) or must they drain through the
    host tier (``"spill"``)?  Device when the consumer is a lowered
    associative fold, the handoff is enabled
    (:func:`..settings.handoff_enabled`) and the scanner emits integer
    counts.  Every decline carries its reason; results are equal either
    way.  The reference also consults its cost model's run history here
    (``cost.handoff_choice``), which the port has not yet: with no history
    it decides "device", as this does."""
    from ..ops import lower as ops_lower

    targets = {d["sid"]: d for d in decisions}
    edges = []
    if not any(d["target"] == "device" for d in decisions):
        return edges
    for sid, stage in enumerate(graph.stages):
        d = targets.get(sid)
        if d is None or d["target"] != "device" or d["kind"] != "map":
            continue
        for cid, cons in enumerate(graph.stages):
            if stage.output not in getattr(cons, "inputs", ()):
                continue
            cd = targets.get(cid)
            edge = {"src": sid, "dst": cid}
            params = ops_lower.claims(stage.mapper)
            if (not isinstance(cons, GReduce) or cd is None
                    or cd["target"] != "device"):
                edge.update(handoff="spill", kind="no-device-consumer",
                            reason="consumer is not a device-lowered fold: "
                                   "outputs drain through the host tier")
            elif not settings.handoff_enabled():
                edge.update(handoff="spill", kind="settings",
                            reason="handoff off (settings.handoff={!r}; hbm "
                                   "budget {} on this device)".format(
                                       settings.handoff,
                                       settings.effective_hbm_budget()))
            elif params is not None and params.get("pair_values"):
                edge.update(handoff="spill", kind="object-lane",
                            reason="pair-values scanner emits an object "
                                   "lane: no device tier for it")
            else:
                edge.update(handoff="device", kind="resident",
                            via=("scanner-program" if params is not None
                                 else "lane-program"),
                            reason="producer program outputs stay "
                                   "HBM-resident into the device fold: "
                                   "d2h/spill/h2d skipped on this edge")
            edges.append(edge)
    return edges


def apply(graph, outputs, runner=None):
    """``(graph', section)``: the graph with lowered stages re-targeted
    (untouched when lowering is off or nothing qualifies) and the
    ``lowering`` report section, whose ``handoff`` lists every edge out of
    a lowered map with its decision.  With ``runner``, the producers of the
    device edges go into ``runner._handoff_sids`` and its store's handoff
    budget is armed (``store.handoff_active``)."""
    section = {"enabled": False, "targets": [], "device_stages": 0,
               "handoff": []}
    if not settings.lower_enabled():
        section["reason"] = "off (settings.lower={!r})".format(settings.lower)
        return graph, section
    decisions = analyze(graph, outputs)
    lowered = [d["sid"] for d in decisions if d["target"] == "device"]
    section.update(enabled=True, targets=decisions,
                   device_stages=len(lowered))
    if not lowered:
        return graph, section
    edges = handoff_analyze(graph, decisions)
    section["handoff"] = edges
    hand_sids = {e["src"] for e in edges if e["handoff"] == "device"}
    if runner is not None:
        runner._handoff_sids = hand_sids
        if hand_sids:
            runner.store.handoff_active = True
    from ..graph import Graph

    stages = list(graph.stages)
    for sid in lowered:
        opts = dict(stages[sid].options or {})
        opts["exec_target"] = "device"
        stages[sid] = ir.clone_with_options(stages[sid], opts)
    return Graph(stages), section
