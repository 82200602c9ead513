"""The rewrite pipeline: Graph -> Graph (port of
``dampr_tpu/plan/passes.py``).

Rules, all run before every run:

- **dead-stage elimination**: stages no requested output and no sink
  reaches are dropped.
- **map fusion**: a GMap ``A`` whose output only GMap ``B`` consumes,
  with no combiner on ``A`` and no barrier on either, collapses into
  ``B``.  Pure per-record chains on both sides compose into one mapper,
  unless the static analyzer (``settings.analyze``) finds an
  evidence-impure UDF on either side;
  an identity tail (a checkpoint head) dissolves into any producer, whose
  mapper (and with it a scanner's block or device path) stays as it was.
  The tail's combiner and output survive on the fused stage.
- **combiner hoisting**: the identity-dissolve rule on a tail that
  carries a combiner, so the map-side fold the DSL plants as its own
  identity stage runs inside the producer's jobs.
- **sink fusion**: a pure record chain whose one consumer is a sink
  composes into the sinker.

Barriers: ``checkpoint()`` stages (``options["barrier"]``) and
``cached()`` pins (``memory``) never dissolve into their consumer (they
may absorb a private producer); stages whose chain holds ``Sample`` or
``Inspect`` fuse in neither direction; a Source with more than one
consumer stays, which covers shared prefixes (``Graph.union`` dedupes
them) and every requested output.

Every rewrite builds fresh nodes; nodes of the input graph are never
mutated (other live handles may share them).
"""

import logging

from .. import settings
from ..graph import GMap, GSink
from . import ir

log = logging.getLogger("dampr_tpu_torch.plan")

RULES = ("fuse_maps", "hoist_combiners", "fuse_sinks", "dead_stages")


def empty_report(graph):
    n = ir.executed_stage_count(graph)
    return {"stages_before": n, "stages_after": n,
            "rules": dict.fromkeys(RULES, 0), "fused": [], "dead": []}


def _dead_stage_elimination(stages, outputs, report):
    """Keep only the stages a requested output or a sink reaches."""
    needed = set(outputs)
    keep = [False] * len(stages)
    for i in range(len(stages) - 1, -1, -1):
        stage = stages[i]
        if isinstance(stage, GSink) or stage.output in needed:
            keep[i] = True
            needed.update(stage.inputs)
    dropped = [i for i, k in enumerate(keep) if not k]
    if not dropped:
        return stages
    report["rules"]["dead_stages"] += len(dropped)
    report["dead"].extend(
        "s{}:{}".format(i, ir.describe_stage(stages[i])) for i in dropped)
    return [s for i, s in enumerate(stages) if keep[i]]


def _impure_blocks_compose(*stages):
    """Does the static analyzer (settings.analyze) veto composing these
    stages' record chains into one stage?  An evidence-impure UDF keeps
    its own stage: fusing it would move its side effects into another
    stage's job and retry scope.  ``assume_pure=True`` stage options
    suppress (honored inside stage_verdict).  Identity dissolves never
    consult this — they leave the surviving mapper untouched."""
    if not settings.analyze:
        return False
    from ..analyze import props

    for s in stages:
        try:
            if not props.stage_verdict(s).pure:
                return True
        except Exception:  # noqa: BLE001 - analysis never fails a plan
            continue  # unclassifiable stage: benefit of the doubt,
            #           but keep checking the OTHER stages
    return False


def _fusable_pair(a, b, counts, protected):
    """May GMap ``b`` absorb its producer GMap ``a``?  The rule's name
    ('fuse_maps' / 'hoist_combiners') or None."""
    if ir.stage_is_barrier(a) or ir.has_barrier_ops(b):
        return None
    if a.output in protected or counts.get(a.output, 0) != 1:
        return None
    if ir.has_combiner(a):
        # a combiner head is a shuffle boundary: its folded output is what
        # its reduce folds again
        return None
    if ir.is_identity_mapper(b.mapper):
        return "hoist_combiners" if ir.has_combiner(b) else "fuse_maps"
    if ir.is_record_chain(a.mapper) and ir.is_record_chain(b.mapper):
        if _impure_blocks_compose(a, b):
            return None
        return "fuse_maps"
    return None


def _fuse_maps(stages, protected, report):
    """Fusion of GMap -> GMap and GMap -> GSink pairs to a fixed point."""
    stages = list(stages)
    changed = True
    while changed:
        changed = False
        counts = ir.consumer_counts(stages, protected)
        producer = ir.producer_index(stages)
        for bi, b in enumerate(stages):
            if not b.inputs:
                continue
            ai = producer.get(b.inputs[0])
            if ai is None:
                continue
            a = stages[ai]
            if not isinstance(a, GMap):
                continue
            if isinstance(b, GMap) and len(b.inputs) == 1:
                rule = _fusable_pair(a, b, counts, protected)
                if rule is None:
                    continue
                if ir.is_identity_mapper(b.mapper):
                    mapper = a.mapper
                else:
                    mapper = ir.compose_mappers(a.mapper, b.mapper)
                fused = GMap(a.inputs, b.output, mapper, b.combiner,
                             ir.merge_options(a.options, b.options))
            elif (isinstance(b, GSink) and len(b.inputs) == 1
                    and not ir.stage_is_barrier(a)
                    and a.output not in protected
                    and counts.get(a.output, 0) == 1
                    and not ir.has_combiner(a)
                    and ir.is_record_chain(a.mapper)
                    and ir.is_record_chain(b.sinker)
                    and not _impure_blocks_compose(a)):
                rule = "fuse_sinks"
                fused = GSink(a.inputs, b.output,
                              ir.compose_mappers(a.mapper, b.sinker),
                              b.path, ir.merge_options(a.options, b.options))
            else:
                continue
            report["rules"][rule] += 1
            report["fused"].append({
                "rule": rule, "into": ir.describe_stage(fused),
                "members": [ir.describe_stage(a), ir.describe_stage(b)]})
            fused._provenance = (
                (ir.stage_provenance(a) or [ir.describe_stage(a)])
                + (ir.stage_provenance(b) or [ir.describe_stage(b)]))
            # the fused node takes the producer's slot (its inputs'
            # producers all precede it); the tail's slot goes
            stages[ai] = fused
            del stages[bi]
            changed = True
            break
    return stages


def optimize(graph, outputs):
    """``(graph', report)`` for the requested ``outputs``, which are never
    fused away or eliminated.  When no rule fires the same graph object
    comes back, so ``optimize`` is idempotent."""
    report = empty_report(graph)
    protected = set(outputs)
    stages = list(graph.stages)
    stages = _dead_stage_elimination(stages, protected, report)
    stages = _fuse_maps(stages, protected, report)
    if not sum(report["rules"].values()):
        return graph, report
    out = ir.rebuilt(stages)
    report["stages_after"] = ir.executed_stage_count(out)
    log.info("plan: %d -> %d stages (%s)", report["stages_before"],
             report["stages_after"],
             ", ".join("{}={}".format(k, v)
                       for k, v in sorted(report["rules"].items()) if v))
    return out, report
