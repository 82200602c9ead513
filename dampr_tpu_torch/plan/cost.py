"""History-driven adaptive sizing and the learned cost model's decisions.

Port of ``dampr_tpu/plan/cost.py``.  Every finalized named run appends
one record to the run-history corpus (:mod:`..obs.history`) with
per-stage records and bytes in and out and the plan's stage shapes.
When the current optimized plan has the same shape sequence, those
measurements (the newest record when fewer than three match, per-stage
medians over the recent window otherwise; a traced run's ``stats.json``
where no corpus exists) size this run:

- **partition count**: re-derived from the largest observed reduce input
  (``settings.plan_partition_bytes`` per partition, clamped), unless the
  caller pinned ``n_partitions``;
- **block batch size**: a map stage whose observed bytes/record is large
  gets a ``batch_size`` option so its blocks target
  ``settings.plan_block_bytes``;
- **reducer job width**: a reduce whose observed input was tiny runs its
  partition jobs on one worker (``n_reducers=1``).

:func:`apply_model` then prices the plan with the per-operator fits
(:mod:`.model`) and may override the partition count; :func:`
handoff_choice` prices the device handoff edge against the spill path.
No history, a shape mismatch or ``settings.plan_adapt`` off leaves the
static defaults.  Every decision lands in the plan report's ``adaptive``
and ``cost`` sections.
"""

import json
import logging
import os

from .. import settings
from ..graph import GMap, GReduce
from . import ir

log = logging.getLogger("dampr_tpu_torch.plan.cost")

def empty_cost_section(reason=None):
    from . import model as _model

    return _model.empty_section(False, reason=reason)


def load_history(run_name):
    """The prior run's stats.json summary for this run name, or None.
    Never raises: adaptation is best-effort."""
    if not run_name:
        return None
    try:
        from ..obs import export

        summary, _path = export.load_stats(run_name)
        return summary
    except Exception:
        log.debug("stats history unreadable for %r", run_name, exc_info=True)
        return None


def corpus_history(run_name, graph):
    """(history, reason) for this run name from the corpus: only records
    whose stage-shape sequence matches ``graph`` count; one or two give
    the newest record verbatim, three or more per-stage medians over the
    ``settings.history_window`` newest.  A name with no corpus falls back
    to its traced run's stats.json.  ``(None, reason)`` when nothing
    usable exists; never raises."""
    if not run_name:
        return None, "no-history"
    shapes_now = ir.stage_shapes(graph)
    try:
        from ..obs import history

        records = history.load(run_name)
        if records:
            matched = history.matching(records, shapes_now)
            if not matched:
                return None, "shape-mismatch"
            window = max(1, settings.history_window)
            return history.synthesize(matched[-window:]), None
    except Exception:
        log.debug("history corpus unreadable for %r", run_name,
                  exc_info=True)
    hist = load_history(run_name)
    if hist is None:
        return None, "no-history"
    shapes_prev = (hist.get("plan") or {}).get("stage_shapes") or []
    if ([s.get("shape") for s in shapes_prev]
            != [s["shape"] for s in shapes_now]):
        return None, "shape-mismatch"
    return hist, None


def matched_history(run_name, graph):
    """The shape-matched history for ``run_name``, or None (the lowering
    pass's placement floor and ``explain()`` read it)."""
    hist, _reason = corpus_history(run_name, graph)
    return hist


def current_model(run_name, graph):
    """The fitted :class:`~.model.CostModel` for a run name (variance
    tables scoped to ``graph``'s fingerprint), or None: model off, no
    corpus, or a read failure."""
    if not settings.cost_model_enabled() or not run_name:
        return None
    try:
        from ..obs import history
        from . import model as _model

        records = history.load(run_name)
        if not records:
            return None
        fp = history.plan_fingerprint(ir.stage_shapes(graph))
        return _model.build(records, fp)
    except Exception:
        log.debug("cost model unavailable for %r", run_name,
                  exc_info=True)
        return None


def handoff_choice(run_name, graph):
    """The corpus-priced handoff-vs-spill decision for this plan's device
    edges (:func:`.lower.handoff_analyze`, auto mode).  Returns (decision,
    reason): ``"device"``/``"spill"``, or None when there is no evidence
    (auto then keeps the edge resident, and the reason says what a
    measurement would add)."""
    if not settings.cost_model_enabled() or not run_name:
        return None, ("no corpus pricing (cost model off or unnamed "
                      "run) — auto keeps the edge resident")
    try:
        from ..obs import history
        from . import model as _model

        records = history.load(run_name)
        if not records:
            return None, ("empty corpus — no handoff-vs-spill evidence "
                          "yet")
        fp = history.plan_fingerprint(ir.stage_shapes(graph))
        return _model.price_handoff(records, fp)
    except Exception:
        log.debug("handoff pricing unavailable for %r", run_name,
                  exc_info=True)
        return None, "corpus pricing unavailable"


def load_tuned(run_name):
    """The persisted autotune winner for a run name
    (``<scratch_root>/<run>/tuned.json``), or None.  Never raises."""
    if not run_name:
        return None
    try:
        safe = str(run_name).replace("/", "_")
        path = os.path.join(settings.scratch_root, safe, "tuned.json")
        if not os.path.isfile(path):
            return None
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except Exception:
        log.debug("tuned.json unreadable for %r", run_name,
                  exc_info=True)
        return None


def shuffle_choice(hist_stage, n_dev, n_partitions, mode=None,
                   model=None):
    """(target, reason): route one redistribution stage over the ``host``
    shuffle or the ``mesh`` byte exchange (:mod:`..parallel.exchange`).
    An explicit ``mode`` (default ``settings.mesh_exchange``) wins; auto
    decides from the corpus: a recorded shuffle input under
    ``settings.exchange_min_bytes`` keeps the host path (the D*D window
    pack and unpack dominate a tiny exchange), a larger or unmeasured one
    rides the collective, and a model with both the exchange and fold
    classes fit decides by modeled seconds."""
    if mode is None:
        mode = settings.mesh_exchange
    m = str(mode).lower()
    if m in ("off", "0", "false") or not settings.use_device:
        return "host", "settings.mesh_exchange={!r} pins the host " \
            "shuffle".format(mode)
    if m in ("on", "1", "true"):
        return "mesh", "settings.mesh_exchange={!r} forces the " \
            "collective exchange".format(mode)
    if n_dev < 2:
        return "host", "single visible device — nothing to exchange over"
    st = hist_stage or {}
    bytes_in = st.get("bytes_in")
    if not bytes_in:
        return "mesh", "{} devices visible, no shuffle history — the " \
            "budgeted collective engages by availability".format(n_dev)
    if model is not None:
        pred = model.shuffle_prediction(bytes_in / 1e6)
        if pred is not None:
            return pred
    if bytes_in < settings.exchange_min_bytes:
        return "host", (
            "history: {} B shuffle input < exchange_min_bytes={} — the "
            "D*D collective window pack/unpack overhead dominates; host "
            "shuffle is cheaper".format(
                bytes_in, settings.exchange_min_bytes))
    recs = st.get("records_in") or st.get("records_out") or 0
    rec_bytes = (bytes_in / float(recs)) if recs else None
    detail = "~{:.0f} B/record, ".format(rec_bytes) if rec_bytes else ""
    return "mesh", (
        "history: {} B shuffle input across {} partitions on {} devices "
        "({}windowed under exchange_hbm_budget={}){}".format(
            bytes_in, n_partitions, n_dev, detail,
            settings.exchange_hbm_budget,
            "; coded aggregation armed (exchange_coding={}) for "
            "sum-combinable folds".format(settings.exchange_coding)
            if settings.exchange_coding_enabled() else ""))


def _clamped_partitions(reduce_bytes):
    want = max(1, -(-int(reduce_bytes) // settings.plan_partition_bytes))
    floor = max(4, min(settings.max_processes, settings.partitions))
    ceil_ = max(settings.partitions, 4 * settings.partitions)
    return max(floor, min(want, ceil_))


def _batch_for(rec_bytes):
    """Records per block so a block targets ``plan_block_bytes``: the
    largest power of two at or under the target, floored at 16."""
    if rec_bytes <= 0:
        return None
    want = max(16, int(settings.plan_block_bytes // rec_bytes))
    b = 16
    while b * 2 <= want:
        b *= 2
    return b


def adapt(runner, graph, report):
    """Apply history-driven sizing to ``runner`` (``n_partitions``) and
    ``runner.graph`` (per-stage options; stages that gain options are
    fresh clones)."""
    from .. import runner as _runner

    info = {"applied": False, "reason": None, "history": None, "changes": []}
    report["adaptive"] = info
    if not settings.plan_adapt:
        info["reason"] = "disabled"
        return
    if getattr(runner, "resume", False):
        info["reason"] = "resumable-run"
        return
    hist, reason = corpus_history(getattr(runner, "name", None), graph)
    if hist is None:
        info["reason"] = reason
        return
    info["history"] = hist.get("stats_file") or hist.get("run")
    info["history_entries"] = hist.get("history_entries", 1)
    by_sid = {s.get("stage"): s for s in hist.get("stages", [])}

    # -- run-level partition count -----------------------------------------
    reduce_bytes = 0
    for i, stage in enumerate(graph.stages):
        if isinstance(stage, GReduce):
            st = by_sid.get(i) or {}
            reduce_bytes = max(reduce_bytes, st.get("bytes_in") or 0)
    if (reduce_bytes > 0
            and not getattr(runner, "_explicit_partitions", True)):
        want = _clamped_partitions(reduce_bytes)
        if want != runner.n_partitions:
            info["changes"].append({
                "what": "n_partitions", "from": runner.n_partitions,
                "to": want, "reduce_bytes_in": reduce_bytes})
            runner.n_partitions = want

    # -- per-stage options --------------------------------------------------
    new_stages = None
    for i, stage in enumerate(graph.stages):
        st = by_sid.get(i) or {}
        opts = None
        if (isinstance(stage, GMap)
                and "batch_size" not in (stage.options or {})):
            recs, nbytes = st.get("records_out") or 0, st.get("bytes_out") or 0
            if recs and nbytes:
                batch = _batch_for(nbytes / float(recs))
                if batch and batch < settings.batch_size:
                    opts = dict(stage.options or {})
                    opts["batch_size"] = batch
                    info["changes"].append({
                        "what": "batch_size", "stage": i, "to": batch,
                        "record_bytes": round(nbytes / float(recs), 1)})
        elif (isinstance(stage, GReduce)
                and "n_reducers" not in (stage.options or {})):
            nbytes = st.get("bytes_in") or 0
            if 0 < nbytes <= _runner.SMALL_STAGE_BYTES:
                opts = dict(stage.options or {})
                opts["n_reducers"] = 1
                info["changes"].append({
                    "what": "n_reducers", "stage": i, "to": 1,
                    "bytes_in": nbytes})
        if opts is not None:
            if new_stages is None:
                new_stages = list(graph.stages)
            new_stages[i] = ir.clone_with_options(stage, opts)
    if new_stages is not None:
        runner.graph = ir.rebuilt(new_stages)
    if info["changes"]:
        info["applied"] = True
        report["rules"]["adaptive"] = len(info["changes"])
        log.info("plan: adaptive sizing applied %d change(s) from %s",
                 len(info["changes"]), info["history"])
    else:
        info["reason"] = "within-defaults"


def _hist_stage_rows(hist, graph):
    """Shape-matched history stages annotated with op class and MB: the
    rows the model search prices this plan with."""
    from . import model as _model

    shape_by_sid = {s["sid"]: s["shape"] for s in ir.stage_shapes(graph)}
    rows = []
    for st in (hist or {}).get("stages") or ():
        row = dict(st)
        row["op_class"] = _model.op_class(
            st, shape_by_sid.get(st.get("stage")))
        row["mb"] = max(st.get("bytes_in") or 0,
                        st.get("bytes_out") or 0) / 1e6
        rows.append(row)
    return rows


def model_view(run_name, graph, n_now=None):
    """The ``corpus -> fits -> confidence -> choices`` pipeline behind
    both :func:`apply_model` (the decision) and ``explain()``'s cost
    lines (the preview), so the two cannot drift.  A dict: ``records``
    (rank-filtered corpus), ``model``, ``rows``, ``ok``/``reason``,
    ``partition_choice`` (against ``n_now``, default
    ``settings.partitions``), ``variance_choices``, ``tuned``,
    ``fingerprint``."""
    from ..obs import history
    from . import model as _model

    out = {"records": [], "model": None, "rows": [], "ok": False,
           "reason": None, "partition_choice": None,
           "variance_choices": [], "tuned": None, "fingerprint": None}
    try:
        records = [r for r in history.load(run_name)
                   if not r.get("rank")]
    except Exception:
        log.debug("model corpus unreadable for %r", run_name,
                  exc_info=True)
        records = []
    out["records"] = records
    if not records:
        out["reason"] = "no-history: empty corpus — static defaults " \
            "stand"
        return out
    fp = history.plan_fingerprint(ir.stage_shapes(graph))
    out["fingerprint"] = fp
    m = _model.build(records, fp)
    out["model"] = m
    hist, hist_reason = corpus_history(run_name, graph)
    rows = _hist_stage_rows(hist, graph) if hist else []
    out["rows"] = rows
    if not rows:
        out["reason"] = "{}: no shape-matched measurements to price " \
            "this plan with — median/static decisions stand".format(
                hist_reason or "shape-mismatch")
        return out
    ok, why = m.confident_for([r["op_class"] for r in rows])
    if not ok:
        out["reason"] = "{} — median-path decisions stand".format(why)
        return out
    out["ok"] = True
    out["partition_choice"] = _model.search_partitions(
        m, rows, n_now if n_now is not None else settings.partitions)
    current = {k: history.knob_value(k) for k in _model.VARIANCE_KNOBS}
    out["variance_choices"] = _model.search_variance_knobs(m, current)
    out["tuned"] = load_tuned(run_name)
    return out


def apply_model(runner, graph, report):
    """The learned cost model's layer (:mod:`.model`): runs after the
    median-path adaptation and may override its partition count when
    the fits are confident, recording every choice and its
    predicted-vs-static delta in ``report["cost"]``.  Off
    (``settings.cost_model``), it records the kill switch and touches
    nothing; an empty or thin corpus leaves the median or static
    decisions with the reason recorded."""
    from . import model as _model

    info = _model.empty_section(False)
    report["cost"] = info
    if not settings.cost_model_enabled():
        info["reason"] = "disabled (settings.cost_model={!r})".format(
            settings.cost_model)
        return
    if not settings.plan_adapt:
        info["reason"] = "plan_adapt off — no history-driven decisions"
        return
    if getattr(runner, "resume", False):
        info["reason"] = "resumable-run (re-sizing would orphan " \
            "checkpoints)"
        return
    run_name = getattr(runner, "name", None)
    if not run_name:
        info["reason"] = "unnamed run — no corpus to learn from"
        info["source"] = "static"
        return
    view = model_view(run_name, graph,
                      n_now=getattr(runner, "n_partitions", None))
    if view["model"] is not None:
        info["model"] = view["model"].to_dict()
    if not view["ok"]:
        info["reason"] = view["reason"]
        info["source"] = ("static" if not view["records"]
                          else "median-fallback")
        return
    m, rows = view["model"], view["rows"]
    info["enabled"] = True
    info["source"] = "model"
    choices = []

    # -- partition count: an autotuned winner, else the modeled argmin ------
    tuned = view["tuned"]
    if tuned and tuned.get("fingerprint") not in (None,
                                                  view["fingerprint"]):
        # measured on another plan shape under this name: never applied
        # (a file without a fingerprint stays accepted)
        info["tuned_stale"] = {"session": tuned.get("session"),
                               "fingerprint": tuned["fingerprint"]}
        tuned = None
    tuned_knobs = (tuned or {}).get("knobs") or {}
    if (not getattr(runner, "_explicit_partitions", True)
            and not getattr(runner, "resume", False)):
        n_now = runner.n_partitions
        tuned_p = tuned_knobs.get("n_partitions")
        if (isinstance(tuned_p, int)
                and _model.in_bounds("n_partitions", tuned_p)
                and tuned_p != n_now):
            choices.append({
                "knob": "n_partitions", "static": n_now,
                "chosen": tuned_p, "applied": True,
                "reason": "autotuned winner (tuned.json session {!r} "
                          "measured it fastest)".format(
                              (tuned or {}).get("session"))})
            runner.n_partitions = tuned_p
        else:
            ch = view["partition_choice"]
            if ch is not None:
                ch["applied"] = True
                runner.n_partitions = ch["chosen"]
                choices.append(ch)

    # -- run-level knobs: observed-variance suggestions (a run never
    #    changes process-wide settings) -------------------------------------
    for ch in view["variance_choices"]:
        ch.setdefault("applied", False)
        choices.append(ch)
    info["choices"] = choices
    if tuned:
        info["tuned"] = {"session": tuned.get("session"),
                         "knobs": tuned_knobs,
                         "wall_seconds": tuned.get("wall_seconds")}

    # -- headline prediction: modeled wall at the chosen vs static sizing ---
    basis_mb = max((r["mb"] for r in rows), default=0.0)
    chosen_s = _model.predict_plan(m, rows, runner.n_partitions)
    static_s = _model.predict_plan(m, rows, settings.partitions)
    if chosen_s and static_s:
        info["predicted"] = {
            "wall_seconds": round(chosen_s, 4),
            "static_wall_seconds": round(static_s, 4),
            "mbps": (round(basis_mb / chosen_s, 3)
                     if chosen_s > 0 else None),
            "static_mbps": (round(basis_mb / static_s, 3)
                            if static_s > 0 else None),
        }
    applied = [c for c in choices if c.get("applied")]
    if applied:
        log.info("plan: cost model applied %d knob choice(s): %s",
                 len(applied),
                 ", ".join("{}={}".format(c["knob"], c["chosen"])
                           for c in applied))
