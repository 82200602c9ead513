"""Streamed-edge analysis: which producer -> consumer stage edges may run
without a barrier.

Port of ``dampr_tpu/plan/pipeline.py``.  The staged executor
materializes every stage's output before its consumer starts a job.
This pass walks the stage list that will execute and marks each
producer -> consumer edge ``streamed`` (the runner may dissolve the
barrier) or ``barrier``, with its reason either way.  Three streamed
shapes exist, each only where the pipelined result equals the staged one:

- ``early_fold`` (map -> keyed fold): finished map jobs publish into a
  bounded queue and a folder thread pre-folds them under the consuming
  reduce's associative op while the map stage runs.  Exact because both
  reduce paths fold the exact hash groups and emit in key order, so for
  commutative ops (integer and bool sums; min/max over numeric values,
  gated per block at run time) regrouping partials changes no output.
- ``chain`` (map -> map the optimizer did not fuse): consumer jobs run per
  finished producer block, collected in the staged job order.  Needs hash
  fan-out on both sides (``settings.sort_runs`` off) and nothing
  downstream that observes block boundaries (reduces, sinks).
- ``merge_stream`` (sorted runs -> final read): the final read already
  streams a k-way merge over the run files; recorded so the table is
  total.

Everything else keeps its barrier: checkpoints and ``cached()`` pins,
sorted-run materialization, multi-consumer outputs, sinks, device-lowered
stages and handoff edges, a runner that resumes or routes a shuffle over
the mesh, and every edge of a run where a mesh fold or exchange could
engage (:func:`_mesh_possible`).  Decisions are computed with
``settings.pipeline`` off too (the report's ``active`` flag records it),
so ``explain()`` always shows the table.

The runner reads the decisions as ``runner._pipeline_edges``, a dispatch
hint keyed by producer sid and never a stage option, so stage
fingerprints stay independent of history.
"""

from .. import base, settings
from ..graph import GInput, GMap, GReduce, GSink

#: Associative-op kinds whose regrouping across partials is exact
#: (commutative under the runtime dtype gate, ``runner._StreamFolder``).
SAFE_FOLD_KINDS = ("sum", "min", "max")


def _consumers(graph):
    by_output = {}
    for sid, stage in enumerate(graph.stages):
        for src in stage.inputs:
            by_output.setdefault(src, []).append(sid)
    return by_output


def _is_barrier_stage(stage):
    """An explicit checkpoint or ``cached()`` pin: the user asked for a
    materialization here."""
    return bool(stage.options.get("barrier") or stage.options.get("memory"))


def _feeds_boundary_sensitive(graph, output, consumers, seen=None):
    """Does ``output`` reach a reduce or a sink through map stages?  Chain
    streaming changes block boundaries (never record sequences), which
    streamed reduce merges and sink part files observe."""
    if seen is None:
        seen = set()
    if output in seen:
        return False
    seen.add(output)
    for sid in consumers.get(output, ()):
        stage = graph.stages[sid]
        if isinstance(stage, (GReduce, GSink)):
            return True
        if isinstance(stage, GMap) and _feeds_boundary_sensitive(
                graph, stage.output, consumers, seen):
            return True
    return False


def _mesh_possible():
    """Could a mesh fold or exchange engage this run?  A forced mesh knob
    or an "auto" one over more than one shard bars streaming: the mesh
    paths window their own input, and their exactness must not depend on
    pre-folded partials."""
    if not settings.use_device:
        return False
    fold = str(settings.mesh_fold).lower()
    exch = str(settings.mesh_exchange).lower()
    if fold in ("on", "1", "true") or exch in ("on", "1", "true"):
        return True
    if fold in ("off", "0", "false") and exch in ("off", "0", "false"):
        return False
    return settings.device_count_for_auto() > 1


def analyze(graph, outputs, runner=None):
    """One decision per producer -> consumer edge, plus the final-read
    edges of requested outputs: ``{src, dst, output, decision, mode,
    reason}`` (``dst`` None for a final read).  Pure analysis: mutates
    neither the graph nor the runner."""
    consumers = _consumers(graph)
    requested = set(outputs or ())
    decisions = []
    resume_active = runner is not None and bool(getattr(runner, "resume",
                                                        False))
    handoff_sids = (getattr(runner, "_handoff_sids", None) or set()
                    if runner is not None else set())
    shuffle_sids = set(
        sid for sid, tgt in
        (getattr(runner, "_shuffle_targets", None) or {}).items()
        if tgt == "mesh") if runner is not None else set()
    mesh = _mesh_possible()

    for sid, stage in enumerate(graph.stages):
        if isinstance(stage, (GInput, GSink)):
            continue
        out = stage.output
        pin = bool(stage.options.get("memory"))
        has_combiner = (stage.combiner is not None
                        or "binop" in stage.options) \
            if isinstance(stage, GMap) else False
        sinks = consumers.get(out, [])
        sorted_run = (isinstance(stage, GMap)
                      and settings.sort_runs_enabled()
                      and not has_combiner and not pin
                      and not any(isinstance(graph.stages[c], GReduce)
                                  for c in sinks))

        def edge(dst, decision, mode, reason):
            decisions.append({
                "src": sid, "dst": dst, "output": getattr(out, "sid", out),
                "decision": decision, "mode": mode, "reason": reason})

        if not sinks:
            if out in requested and sorted_run:
                edge(None, "streamed", "merge_stream",
                     "spill-merge generations stream into the final "
                     "k-way merge read")
            elif out in requested:
                edge(None, "barrier", None,
                     "requested output materializes")
            continue

        for dst in sinks:
            cons = graph.stages[dst]
            if not isinstance(stage, GMap):
                edge(dst, "barrier", None, "non-map producer")
                continue
            if _is_barrier_stage(stage) or _is_barrier_stage(cons):
                edge(dst, "barrier", None,
                     "explicit checkpoint/cached materialization")
                continue
            if len(sinks) > 1:
                edge(dst, "barrier", None, "multi-consumer output")
                continue
            if out in requested:
                edge(dst, "barrier", None,
                     "requested output materializes")
                continue
            if resume_active:
                edge(dst, "barrier", None,
                     "resume checkpointing persists stage boundaries")
                continue
            if (stage.options.get("exec_target") == "device"
                    or cons.options.get("exec_target") == "device"):
                edge(dst, "barrier", None, "device-lowered stage")
                continue
            if sid in handoff_sids or dst in handoff_sids:
                edge(dst, "barrier", None, "device handoff edge")
                continue
            if sid in shuffle_sids or dst in shuffle_sids:
                edge(dst, "barrier", None, "mesh-routed exchange")
                continue
            if mesh:
                edge(dst, "barrier", None,
                     "mesh fold/exchange may engage")
                continue

            if isinstance(cons, GReduce):
                if len(cons.inputs) != 1:
                    edge(dst, "barrier", None, "multi-input reduce (join)")
                elif pin:
                    edge(dst, "barrier", None, "memory-pinned producer")
                elif (isinstance(cons.reducer, base.AssocFoldReducer)
                      and getattr(cons.reducer.op, "kind", None)
                      in SAFE_FOLD_KINDS):
                    edge(dst, "streamed", "early_fold",
                         "associative {} fold: partials pre-fold during "
                         "the map stage (runtime gates per-block dtypes)"
                         .format(cons.reducer.op.kind))
                else:
                    edge(dst, "barrier", None,
                         "order-sensitive reduce (no commutative "
                         "associative op)")
                continue

            if isinstance(cons, GSink):
                edge(dst, "barrier", None, "sink part files materialize")
                continue

            # map -> map chain
            if sorted_run:
                edge(dst, "barrier", None,
                     "sorted-run materialization (spill-lean external "
                     "sort)")
                continue
            if has_combiner:
                edge(dst, "barrier", None,
                     "producer compaction may re-fold partials")
                continue
            if len(cons.inputs) != 1:
                edge(dst, "barrier", None, "multi-input consumer (join)")
                continue
            if cons.combiner is not None or "binop" in cons.options:
                edge(dst, "barrier", None, "consumer carries a combiner")
                continue
            if not base.is_pure_record_stream(cons.mapper):
                edge(dst, "barrier", None,
                     "consumer is not a pure record stream")
                continue
            if (settings.sort_runs_enabled()
                    and not bool(cons.options.get("memory"))):
                edge(dst, "barrier", None,
                     "sorted-run materialization (consumer side)")
                continue
            if _feeds_boundary_sensitive(graph, cons.output, consumers):
                edge(dst, "barrier", None,
                     "downstream reduce/sink observes block boundaries")
                continue
            edge(dst, "streamed", "chain",
                 "pure record chain: consumer jobs run per completed "
                 "producer block, collected in staged order")
    return decisions


def empty_section(active):
    return {"active": bool(active), "edges": [], "streamed": 0,
            "barriers": 0}


def apply(runner, graph, outputs, report):
    """Put the edge decisions over ``graph`` in ``report["pipeline"]`` and,
    with ``settings.pipeline`` on, the runner's hints: producer sid -> its
    one streamed edge (``runner._pipeline_edges``)."""
    active = settings.pipeline_enabled()
    try:
        decisions = analyze(graph, outputs, runner=runner)
    except Exception:  # noqa: BLE001 - planning analysis never fails a run
        report["pipeline"] = empty_section(active)
        return
    streamed = [d for d in decisions if d["decision"] == "streamed"]
    report["pipeline"] = {
        "active": active,
        "edges": decisions,
        "streamed": len(streamed),
        "barriers": len(decisions) - len(streamed),
    }
    hints = {}
    if active:
        for d in streamed:
            if d["mode"] in ("early_fold", "chain") and d["dst"] is not None:
                hints[d["src"]] = {"mode": d["mode"], "dst": d["dst"]}
    if runner is not None:
        runner._pipeline_edges = hints
