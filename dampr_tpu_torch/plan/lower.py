"""The device-lowering pass: assign each executed stage a target.

Port of ``dampr_tpu/plan/lower.py`` (``analyze`` with its history
placement floor, ``handoff_analyze`` with its corpus pricing, ``apply``,
and the host-or-mesh shuffle routing ``shuffle_analyze``/
``apply_shuffle``):

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

In "auto" lowering a named run's shape-matched history (:mod:`.cost`)
places a stage back on the host when it emitted fewer than
:data:`LOWER_MIN_RECORDS` records.  Lowered stages get
``options["exec_target"] = "device"`` on a fresh clone; the decisions
with their reasons land in the plan report's ``lowering`` section.
Master switch: ``settings.lower``.  Each edge from a lowered map into a
lowered fold may then keep its counts on the device
(:func:`handoff_analyze`, ``settings.handoff``), unless the run's corpus
prices the spill path faster.
"""

import logging

from .. import base, settings
from ..graph import GMap, GReduce
from . import ir

log = logging.getLogger("dampr_tpu_torch.plan.lower")

#: The history placement floor: in "auto" lowering a stage the plan would
#: lower stays on the host when its shape-matched history shows it emitted
#: fewer records than this (a dispatch costs more than it saves).
LOWER_MIN_RECORDS = 4096


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


def is_sort_stage(stage):
    """A map whose chain re-keys for a global sort (``sort_by``'s
    ``Rekey``): its output is read back key-sorted, and that read's range
    redistribution is a shuffle to route."""
    if not isinstance(stage, GMap):
        return False
    return any(isinstance(p, base.Rekey)
               for p in ir.flatten_mapper(stage.mapper))


def analyze(graph, outputs=(), history=None):
    """Per-executed-stage decisions: [{sid, kind, target, reason}].
    ``history`` (a shape-matched summary, :func:`.cost.matched_history`)
    drives the placement floor."""
    by_sid = {}
    if history:
        by_sid = {s.get("stage"): s for s in history.get("stages", [])}
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
        if target == "device":
            recs = (by_sid.get(sid) or {}).get("records_out")
            if recs is not None and recs < LOWER_MIN_RECORDS:
                target, reason = "host", (
                    "history: {} records < lower_min_records={} — dispatch "
                    "overhead dominates".format(recs, LOWER_MIN_RECORDS))
        decisions.append({"sid": sid, "kind": kind, "target": target,
                          "reason": reason})
    return decisions


def handoff_analyze(graph, decisions, run_name=None):
    """Per edge out of a lowered map: may its counts stay on the device
    into the consumer (``handoff="device"``) or must they drain through the
    host tier (``"spill"``)?  Device when the consumer is a lowered
    associative fold, the handoff is enabled
    (:func:`..settings.handoff_enabled`), the scanner emits integer
    counts, and, unless the handoff is forced, the corpus of ``run_name``
    does not price the spill path faster (:func:`.cost.handoff_choice`:
    edge kind ``"priced"``).  Every decline carries its reason; results
    are equal either way."""
    from ..ops import lower as ops_lower

    targets = {d["sid"]: d for d in decisions}
    edges = []
    if not any(d["target"] == "device" for d in decisions):
        return edges
    priced = None
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
                            reason="consumer is not a device-lowered fold "
                                   "— outputs drain through the host "
                                   "tier")
            elif not settings.handoff_enabled():
                edge.update(handoff="spill", kind="settings",
                            reason="handoff off (settings.handoff={!r}; hbm "
                                   "budget {} on this backend)".format(
                                       settings.handoff,
                                       settings.effective_hbm_budget()))
            elif params is not None and params.get("pair_values"):
                edge.update(handoff="spill", kind="object-lane",
                            reason="pair-values scanner emits an object "
                                   "lane — no device tier for it")
            else:
                if not settings.handoff_forced() and run_name:
                    if priced is None:
                        from . import cost

                        priced = cost.handoff_choice(run_name, graph)
                    if priced[0] == "spill":
                        edge.update(handoff="spill", kind="priced",
                                    reason=priced[1])
                        edges.append(edge)
                        continue
                edge.update(handoff="device", kind="resident",
                            via=("scanner-program" if params is not None
                                 else "lane-program"),
                            reason="producer program outputs stay "
                                   "HBM-resident into the device fold: "
                                   "d2h/spill/h2d skipped on this edge"
                                   + ("" if priced is None
                                      or priced[0] is None
                                      else " ({})".format(priced[1])))
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
    from . import cost

    run_name = getattr(runner, "name", None)
    # history places stages in "auto" only: a forced switch stays
    # deterministic whatever the corpus holds
    history = (None if settings.lower_forced()
               else cost.matched_history(run_name, graph))
    decisions = analyze(graph, outputs, history)
    lowered = [d["sid"] for d in decisions if d["target"] == "device"]
    section.update(enabled=True, targets=decisions,
                   device_stages=len(lowered))
    if not lowered:
        return graph, section
    edges = handoff_analyze(graph, decisions, run_name=run_name)
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


def empty_shuffle_section(enabled):
    return {"enabled": enabled, "targets": [], "mesh_stages": 0}


def shuffle_analyze(graph, history, n_dev, n_partitions, device_sids=(),
                    model=None):
    """Per-redistribution-stage shuffle decisions
    ``[{sid, kind, target, reason}]``: every reduce (the group_by,
    fold_by and join exchange) and every reduce-free sort re-key map (its
    sorted read's range exchange).  A device-lowered reduce is recorded,
    not routed: its redistribution rides the keyed fold program."""
    from . import cost

    by_sid = {}
    if history:
        by_sid = {s.get("stage"): s for s in history.get("stages", [])}
    decisions = []
    for sid, stage in enumerate(graph.stages):
        if isinstance(stage, GReduce):
            kind = "reduce"
        elif is_sort_stage(stage):
            # a re-key feeding a reduce is a group_by's key pass: the
            # reduce gets the row
            if any(isinstance(c, GReduce) for c in graph.stages
                   if stage.output in getattr(c, "inputs", ())):
                continue
            kind = "sort"
        else:
            continue
        if sid in device_sids:
            decisions.append({
                "sid": sid, "kind": kind, "target": "device",
                "reason": "device-lowered fold — redistribution rides "
                          "the collective fold program, not the byte "
                          "exchange"})
            continue
        target, reason = cost.shuffle_choice(
            by_sid.get(sid), n_dev, n_partitions, model=model)
        decisions.append({"sid": sid, "kind": kind, "target": target,
                          "reason": reason})
    return decisions


def apply_shuffle(graph, lowering, runner=None):
    """The ``shuffle`` report section: host-or-mesh decisions for the
    redistribution stages (``settings.mesh_exchange``; "auto" from the
    shard count and the run's corpus), and with ``runner`` the routing
    map ``runner._shuffle_targets`` ({sid: "mesh"|"host"}), a dispatch
    hint the runner's exchange reads, never a stage option.  A stage
    whose exchange timed out in an earlier run under the name (an
    ``exchange_timeout`` fault event) stays on the host shuffle unless
    the mode is "on"."""
    section = empty_shuffle_section(False)
    mode = str(settings.mesh_exchange).lower()
    if mode in ("off", "0", "false") or not settings.use_device:
        section["reason"] = (
            "off (settings.mesh_exchange={!r}; every redistribution "
            "stays on the host shuffle)".format(settings.mesh_exchange))
        return section
    from .. import faults as _faults
    from . import cost

    forced = mode in ("on", "1", "true")
    n_dev = 2 if forced else settings.device_count_for_auto()
    run_name = getattr(runner, "name", None)
    device_sids = {d["sid"] for d in (lowering or {}).get("targets", [])
                   if d["target"] == "device" and d["kind"] == "reduce"}
    decisions = shuffle_analyze(
        graph, cost.matched_history(run_name, graph), n_dev,
        getattr(runner, "n_partitions", settings.partitions), device_sids,
        model=cost.current_model(run_name, graph))
    if not forced:
        timed_out = _faults.stages_with_exchange_timeouts(run_name)
        for d in decisions:
            if d["target"] == "mesh" and d["sid"] in timed_out:
                d["target"] = "host"
                d["reason"] = (
                    "fault-history: a previous run's collective exchange "
                    "timed out at this stage (exchange_timeout_ms) — "
                    "degraded to the host shuffle; delete the run's "
                    "faults.jsonl to re-try the mesh")
                log.warning("plan: stage %d shuffle degraded to host "
                            "after a recorded exchange timeout", d["sid"])
    section["enabled"] = True
    section["targets"] = decisions
    section["mesh_stages"] = sum(1 for d in decisions
                                 if d["target"] == "mesh")
    if settings.exchange_coding_enabled():
        section["coding"] = str(settings.exchange_coding)
    if runner is not None:
        runner._shuffle_targets = {
            d["sid"]: d["target"] for d in decisions
            if d["target"] in ("mesh", "host")}
    return section
