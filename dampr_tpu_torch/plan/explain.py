"""Render a pipeline's plan: the stage lists before and after the rewrite
passes, the fusion decisions, the history the adaptive layer would use,
the cost model's trace, the targets and handoff edges, the shuffle
routes, the streamed edges, the analyzer's verdicts and the cross-run
cache's preview.

Port of ``dampr_tpu/plan/explain.py``, surfaced as ``PBase.explain()``.
Pure rendering: ``explain()`` never executes the pipeline and never
mutates the handle's graph.  Its shuffle lines route each
redistribution as :func:`.lower.apply_shuffle` would.
"""

from .. import settings
from ..graph import GInput
from . import cost, ir, lower, passes, pipeline as _pipeline


def _stage_lines(graph, indent="  "):
    pos = {s.output: i for i, s in enumerate(graph.stages)}
    lines = []
    for i, stage in enumerate(graph.stages):
        srcs = ", ".join("s{}".format(pos.get(s, "?")) for s in stage.inputs)
        arrow = " <- {}".format(srcs) if srcs else ""
        tag = "" if not isinstance(stage, GInput) else "  (free)"
        lines.append("{}s{}: {}{}{}".format(
            indent, i, ir.describe_stage(stage), arrow, tag))
    return lines


def explain_text(graph, outputs, name=None):
    """The plan as display text.  ``name`` (a run name) reads that run's
    history, so the adaptive and cost lines show what the run would
    use."""
    lines = []
    n_before = ir.executed_stage_count(graph)
    lines.append("== logical plan ({} stages, {} executed) =="
                 .format(len(graph.stages), n_before))
    lines.extend(_stage_lines(graph))
    optimized, report = passes.optimize(graph, outputs)
    lines.append("== optimized plan ({} executed) =="
                 .format(report["stages_after"]))
    lines.extend(_stage_lines(optimized))
    fired = {k: v for k, v in sorted(report["rules"].items()) if v}
    lines.append("rules fired: {}".format(
        ", ".join("{}={}".format(k, v) for k, v in fired.items())
        if fired else "none (plan already minimal)"))
    for f in report["fused"]:
        lines.append("  {}: {}  =>  {}".format(
            f["rule"], "  +  ".join(f["members"]), f["into"]))
    for d in report["dead"]:
        lines.append("  dead: {}".format(d))
    if not settings.plan_adapt:
        lines.append("adaptive: off (settings.plan_adapt)")
    else:
        hist, reason = (cost.corpus_history(name, optimized)
                        if name else (None, "no-history"))
        if hist is None:
            what = ("history shape mismatch"
                    if reason == "shape-mismatch" else "no history{}".format(
                        " for run {!r}".format(name) if name else ""))
            lines.append("adaptive: {} — static defaults "
                         "(partitions={}, batch_size={})".format(
                             what, settings.partitions,
                             settings.batch_size))
        else:
            n = hist.get("history_entries", 1)
            lines.append("adaptive: history {} ({} stages measured{})"
                         .format(hist.get("stats_file") or name,
                                 len(hist.get("stages", [])),
                                 ", median over {} runs".format(n)
                                 if n >= 3 else ""))
            for st in hist.get("stages", []):
                lines.append(
                    "    s{}: {}  {} rec / {} B out".format(
                        st.get("stage"), st.get("kind"),
                        st.get("records_out"), st.get("bytes_out")))
    lines.extend(_cost_lines(optimized, name))
    lines.extend(_target_lines(optimized, name, outputs))
    lines.extend(_shuffle_lines(optimized, name, outputs))
    lines.extend(_pipeline_lines(optimized, outputs))
    lines.extend(_analysis_lines(optimized))
    lines.extend(_reuse_lines(optimized))
    return "\n".join(lines)


def _pipeline_lines(graph, outputs=()):
    """The streamed-edge decision table (:mod:`.pipeline`)."""
    decisions = _pipeline.analyze(graph, outputs)
    if not decisions:
        return []
    n_str = sum(1 for d in decisions if d["decision"] == "streamed")
    state = ("on" if settings.pipeline_enabled()
             else "OFF (settings.pipeline — staged execution)")
    lines = ["pipeline: {} of {} stage edge(s) streamed — {}".format(
        n_str, len(decisions), state)]
    for d in decisions:
        dst = "s{}".format(d["dst"]) if d["dst"] is not None else "read"
        what = ("streamed[{}]".format(d["mode"])
                if d["decision"] == "streamed" else "barrier")
        lines.append("  s{} -> {}: {}  ({})".format(
            d["src"], dst, what, d["reason"]))
    return lines


def _analysis_lines(graph):
    """The static analyzer's verdicts (:mod:`..analyze`): one line per
    executed stage plus every coded diagnostic, the records a run ships
    in ``stats()["plan"]["analysis"]``."""
    if not settings.analyze:
        return ["analysis: off (settings.analyze)"]
    from ..analyze import validate as _av

    sec = _av.report_section(graph,
                             probe_traceable=settings.lower_enabled())
    c = sec["counts"]
    lines = ["analysis: {} stage(s) classified — {} error(s), {} "
             "warning(s), {} info".format(
                 len(sec["stages"]), c["error"], c["warn"], c["info"])]
    for st in sec["stages"]:
        marks = []
        if not st["pure"]:
            marks.append("impure")
        if not st["deterministic"]:
            marks.append("nondet")
        fold = st.get("fold_assoc")
        if fold is not None:
            marks.append("fold-assoc:" + fold["assoc"])
        if st.get("traceable"):
            marks.append("jax-traceable (certified)")
        lines.append("  s{}: {}  [{}]".format(
            st["sid"], st["stage"],
            ", ".join(marks) if marks else "pure, deterministic"))
    for d in sec["diagnostics"]:
        lines.append("  {}: {} s{} {}".format(
            d["severity"], d["code"], d["sid"], d["message"]))
        for e in d["evidence"][:3]:
            lines.append("      - {}".format(e))
    return lines


def _reuse_lines(graph):
    """The cross-run cache's preview (:mod:`.reuse`): a read-only consult
    of the shared cache with the runner's key derivation, so which stages
    would mount and which would miss.  The preview keys with the static
    ``settings.partitions`` salt (a run that sizes its partitions keys
    otherwise), and a cache error becomes a one-line note, never an
    exception."""
    if not settings.reuse_enabled():
        return ["reuse: off (settings.reuse / DAMPR_TPU_TORCH_REUSE) — "
                "every run recomputes from its inputs"]
    from ..graph import GSink
    from . import reuse as _reuse

    try:
        keys, _structs, _sigs = _reuse.reuse_keys(
            graph, "p{}".format(settings.partitions))
        cache = _reuse.CacheStore()
        lines = ["reuse: cache {} ({:.1f} MB used, budget {:.1f} MB)"
                 .format(cache.root, cache.total_bytes() / 1e6,
                         cache.budget / 1e6)]
        for sid, stage in enumerate(graph.stages):
            if isinstance(stage, (GInput, GSink)):
                continue
            if _reuse._resume.is_volatile(keys[sid]):
                lines.append("  s{}: volatile (never cached)".format(sid))
                continue
            try:
                hit = cache.lookup(keys[sid]) is not None
            except _reuse.CacheEntryError:
                lines.append("  s{}: corrupt entry (would recompute)"
                             .format(sid))
                continue
            lines.append("  s{}: {}".format(
                sid, "cached (would mount)" if hit else "miss"))
        return lines
    except Exception as exc:  # a preview never breaks explain()
        return ["reuse: preview unavailable ({})".format(exc)]


def _cost_lines(graph, name):
    """The cost model's decision trace, rendered from the same
    :func:`.cost.model_view` the run decides with."""
    if not settings.cost_model_enabled():
        return ["cost model: off (settings.cost_model) — median-path "
                "adaptation only"]
    if not settings.plan_adapt:
        return ["cost model: plan_adapt off — no history-driven "
                "decisions"]
    if not name:
        return ["cost model: no run name — nothing learned yet"]
    view = cost.model_view(name, graph)
    m = view["model"]
    if m is None:
        return ["cost model: empty corpus for run {!r} — static "
                "defaults stand".format(name)]
    lines = ["cost model: {} corpus record(s), {} operator class(es) "
             "fit".format(m.n_records, len(m.fits))]
    for cls, f in sorted(m.fits.items()):
        d = f.to_dict()
        lines.append("  {:<9} {:>8} s/MB  {:>8} s/job  ({} pts, "
                     "r2 {})".format(cls, d["secs_per_mb"],
                                     d["secs_per_job"], d["points"],
                                     d["r2"]))
    if not view["ok"]:
        lines.append("  abstaining: {}".format(view["reason"]))
        return lines
    ch = view["partition_choice"]
    if ch is not None:
        lines.append("  n_partitions: {} -> {}  (predicted {}s vs "
                     "static {}s)".format(
                         ch["static"], ch["chosen"],
                         ch["predicted_seconds"], ch["static_seconds"]))
    for c in view["variance_choices"]:
        if c.get("chosen") != c.get("static"):
            lines.append("  {}: {!r} -> {!r}  ({})".format(
                c["knob"], c["static"], c["chosen"], c["reason"]))
    tuned = view["tuned"]
    if tuned:
        stale = tuned.get("fingerprint") not in (None,
                                                 view["fingerprint"])
        lines.append("  autotuned winner on file: {} (session {!r}{})"
                     .format(tuned.get("knobs"), tuned.get("session"),
                             " — STALE: different plan shape, not "
                             "applied" if stale else ""))
    return lines


def _shuffle_lines(graph, name, outputs=()):
    """The host-or-mesh route of each redistribution stage, as
    :func:`.lower.apply_shuffle` decides it: which exchanges ride the
    budgeted collective and why the rest keep the host shuffle; a
    device-lowered reduce is target ``device``."""
    mode = str(settings.mesh_exchange).lower()
    if mode in ("off", "0", "false") or not settings.use_device:
        return ["shuffle: mesh exchange off (settings.mesh_exchange={!r}; "
                "every redistribution on the host shuffle)".format(
                    settings.mesh_exchange)]
    n_dev = (2 if mode in ("on", "1", "true")
             else settings.device_count_for_auto())
    device_sids = set()
    if settings.lower_enabled():
        hist_l = (cost.matched_history(name, graph)
                  if name and not settings.lower_forced() else None)
        device_sids = {
            d["sid"] for d in lower.analyze(graph, outputs, hist_l)
            if d["target"] == "device" and d["kind"] == "reduce"}
    decisions = lower.shuffle_analyze(
        graph, cost.matched_history(name, graph) if name else None,
        n_dev, settings.partitions, device_sids,
        model=cost.current_model(name, graph) if name else None)
    if not decisions:
        return []
    n_mesh = sum(1 for d in decisions if d["target"] == "mesh")
    lines = ["shuffle: {} of {} redistribution stage(s) routed over the "
             "mesh exchange (hbm budget {})".format(
                 n_mesh, len(decisions), settings.exchange_hbm_budget)]
    for d in decisions:
        lines.append("  s{}: {} shuffle -> {}  ({})".format(
            d["sid"], d["kind"], d["target"], d["reason"]))
    return lines


def _target_lines(graph, name, outputs=()):
    """Per-stage execution targets (the lowering pass) and the handoff
    edges between lowered stages."""
    lines = []
    if not settings.lower_enabled():
        lines.append("targets: device lowering off (settings.lower={!r}; "
                     "every stage executes on host)".format(settings.lower))
        return lines
    decisions = lower.analyze(
        graph, outputs,
        (cost.matched_history(name, graph)
         if name and not settings.lower_forced() else None))
    n_dev = sum(1 for d in decisions if d["target"] == "device")
    lines.append("targets: {} of {} executed stages lowered to device "
                 "programs".format(n_dev, len(decisions)))
    for d in decisions:
        lines.append("  s{}: {} -> {}  ({})".format(
            d["sid"], d["kind"], d["target"], d["reason"]))
    edges = lower.handoff_analyze(graph, decisions, run_name=name)
    if edges:
        n_hand = sum(1 for e in edges if e["handoff"] == "device")
        lines.append("handoff: {} of {} device edge(s) stay "
                     "HBM-resident across the stage boundary".format(
                         n_hand, len(edges)))
        for e in edges:
            lines.append("  s{} -> s{}: {}  ({})".format(
                e["src"], e["dst"], e["handoff"], e["reason"]))
    return lines
