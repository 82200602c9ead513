"""Pre-flight plan validator: walk the stage IR, emit coded diagnostics.

Port of ``dampr_tpu/analyze/validate.py``: the same codes, severities,
ordering and fold dedup.  Diagnostic codes (stable API — tests and
docs/analysis.md pin them):

==========  ========  ====================================================
code        severity  meaning
==========  ========  ====================================================
``DTA101``  error     non-associative fold binop under combiner
                      decomposition (algebraic counterexample attached) —
                      results would depend on chunking
``DTA102``  info      opaque fold binop passed the randomized
                      associativity probe (probabilistic, not a proof)
``DTA201``  warn      impure UDF (evidence attached): fusion declines to
                      fuse across it, retries/resume re-execute it, and a
                      checkpoint alias may skip its side effects
``DTA301``  warn      nondeterministic UDF: speculative re-execution is
                      declined for its stage, and retried/resumed runs
                      may produce different results
``DTA401``  warn      unpicklable captured state (the closure variable is
                      named): breaks process-pool/mesh dispatch and makes
                      checkpoint fingerprints volatile.  Promoted to a
                      HARD ERROR at dispatch time on multi-process runs
                      (:func:`preflight_dispatch_check`).
``DTA402``  warn      fingerprint-unstable operator under ``resume=`` /
                      ``cached()`` (the JAX package's; not here yet: the
                      port has no resume fingerprints, and
                      ``validate_graph(resume=True)`` raises)
``DTA501``  info      certified numeric chain (:mod:`.torchtrace`): it
                      lowers to the device as one lane program
==========  ========  ====================================================

Suppressions ride per-stage options (``custom_mapper(m,
assume_pure=True)``-style; any op-adding DSL call accepting ``options``
works): ``assume_pure``, ``assume_deterministic``,
``assume_associative``, ``assume_picklable``.
"""

from ..graph import GInput, GMap, GReduce, GSink
from . import assoc as _assoc
from . import pickleprobe, props

SEVERITIES = ("error", "warn", "info")


class Diagnostic(object):
    __slots__ = ("code", "severity", "sid", "stage", "message", "evidence")

    def __init__(self, code, severity, sid, stage, message, evidence=()):
        assert severity in SEVERITIES
        self.code = code
        self.severity = severity
        self.sid = sid
        self.stage = stage
        self.message = message
        self.evidence = list(evidence)

    def to_dict(self):
        return {"code": self.code, "severity": self.severity,
                "sid": self.sid, "stage": self.stage,
                "message": self.message, "evidence": list(self.evidence)}

    def render(self):
        head = "{}: {} [s{}: {}] {}".format(
            self.severity, self.code, self.sid, self.stage, self.message)
        return "\n".join([head] + ["    - " + e for e in self.evidence])

    def __repr__(self):
        return "Diagnostic({}, {}, s{})".format(
            self.code, self.severity, self.sid)


class PreflightError(RuntimeError):
    """A validator error promoted to a hard failure at dispatch time.
    Carries the diagnostics on ``.diagnostics``."""

    def __init__(self, diagnostics):
        self.diagnostics = list(diagnostics)
        super(PreflightError, self).__init__(
            "pre-flight validation failed:\n" + "\n".join(
                d.render() for d in self.diagnostics))


def _stage_ops(stage):
    from ..plan import ir

    if isinstance(stage, GMap):
        parts = list(ir.flatten_mapper(stage.mapper))
        if stage.combiner is not None:
            parts.append(stage.combiner)
        return parts
    if isinstance(stage, GReduce):
        return [stage.reducer]
    if isinstance(stage, GSink):
        return list(ir.flatten_mapper(stage.sinker))
    return []


def _fold_binop(stage):
    """The raw fold binop a stage carries (combiner or binop option)."""
    from .. import base

    opts = getattr(stage, "options", None) or {}
    if isinstance(getattr(stage, "combiner", None),
                  base.PartialReduceCombiner):
        return stage.combiner.op
    if "binop" in opts:
        return opts["binop"]
    red = getattr(stage, "reducer", None)
    if isinstance(red, base.AssocFoldReducer):
        return red.op
    return None


def stage_analysis(stage, sid, probe_traceable=False, probe_assoc=False,
                   probe_pickle=True):
    """One stage's merged analysis record (the plan report row).

    ``probe_pickle=False`` skips the serialization probe (it pickles
    captured state — the per-run report section stays bytecode-only;
    ``picklable`` is then None = unprobed, never a diagnostic)."""
    from ..plan import ir

    opts = getattr(stage, "options", None) or {}
    v = props.stage_verdict(stage)
    rec = {
        "sid": sid,
        "kind": ir.stage_kind(stage),
        "stage": ir.describe_stage(stage),
        "pure": v.pure,
        "deterministic": v.deterministic,
        "impure_evidence": list(v.impure_evidence),
        "nondet_evidence": list(v.nondet_evidence),
    }
    if not probe_pickle:
        rec["picklable"] = None
        rec["pickle_problems"] = []
    else:
        problems = []
        if not opts.get("assume_picklable"):
            for op in _stage_ops(stage):
                problems.extend(pickleprobe.probe_operator(op))
        rec["picklable"] = not problems
        rec["pickle_problems"] = problems
    binop = _fold_binop(stage)
    if binop is not None:
        if opts.get("assume_associative"):
            rec["fold_assoc"] = {"assoc": "yes", "kind": None,
                                 "evidence": "assume_associative override"}
        elif probe_assoc:
            rec["fold_assoc"] = _assoc.classify_binop(binop)
        else:
            from ..ops import segment

            op = segment.as_assoc_op(binop)
            rec["fold_assoc"] = {
                "assoc": "yes" if op.kind is not None else "unknown",
                "kind": op.kind,
                "evidence": ("recognized associative kind {!r}".format(
                    op.kind) if op.kind is not None
                    else "opaque binop (unprobed at run time; "
                         "dampr-tpu-lint runs the algebraic probe)")}
    if probe_traceable and isinstance(stage, GMap) \
            and len(stage.inputs) == 1:
        from . import torchtrace

        spec, why = torchtrace.chain_claims(stage.mapper)
        rec["traceable"] = spec is not None
        rec["traceable_why"] = why
    return rec


def _diagnose_stage(rec, stage, diagnostics):
    sid, desc = rec["sid"], rec["stage"]
    if not rec["pure"]:
        diagnostics.append(Diagnostic(
            "DTA201", "warn", sid, desc,
            "impure UDF: fusion will not fuse across this stage, retries "
            "and resume re-execute its side effects, and a checkpoint "
            "alias may skip them (suppress with assume_pure=True)",
            rec["impure_evidence"]))
    if not rec["deterministic"]:
        diagnostics.append(Diagnostic(
            "DTA301", "warn", sid, desc,
            "nondeterministic UDF: speculative re-execution is declined "
            "for this stage; retried or resumed runs may differ "
            "(suppress with assume_deterministic=True)",
            rec["nondet_evidence"]))
    if rec["picklable"] is False:
        diagnostics.append(Diagnostic(
            "DTA401", "warn", sid, desc,
            "unpicklable captured state: a multi-process dispatch of "
            "this stage fails (hard error at dispatch time), and its "
            "checkpoint fingerprint is volatile",
            ["{}: {} is unpicklable ({})".format(
                p["where"], p["variable"], p["error"])
             for p in rec["pickle_problems"]]))
    fold = rec.get("fold_assoc")
    if fold is not None:
        if fold["assoc"] == "no":
            diagnostics.append(Diagnostic(
                "DTA101", "error", sid, desc,
                "non-associative fold binop under map-side combine -> "
                "shuffle -> final-fold decomposition: results depend on "
                "chunking (use group_by(...).reduce for order-sensitive "
                "folds, or assume_associative=True to override)",
                [fold["evidence"]]))
        elif fold["assoc"] == "probably":
            diagnostics.append(Diagnostic(
                "DTA102", "info", sid, desc,
                "opaque fold binop passed the randomized associativity "
                "probe", [fold["evidence"]]))
    if rec.get("traceable"):
        diagnostics.append(Diagnostic(
            "DTA501", "info", sid, desc,
            "certified jax-traceable numeric chain: device-lowerable "
            "through the widened vocabulary",
            [rec.get("traceable_why", "")]))


def analyze_stages(graph, probe_traceable=False, probe_assoc=False,
                   probe_pickle=True):
    """Per-executed-stage analysis records for a graph."""
    out = []
    for sid, stage in enumerate(graph.stages):
        if isinstance(stage, GInput):
            continue
        out.append(stage_analysis(stage, sid,
                                  probe_traceable=probe_traceable,
                                  probe_assoc=probe_assoc,
                                  probe_pickle=probe_pickle))
    return out


def validate_graph(graph, resume=False, num_processes=1,
                   probe_traceable=True, probe_assoc=True,
                   probe_pickle=True):
    """Full pre-flight validation -> ordered [Diagnostic] (errors first).

    ``num_processes > 1`` promotes unpicklable captures to errors (they
    WILL fail at the process boundary).  ``resume=True`` (the JAX
    package's fingerprint-stability check, ``DTA402``) raises: the port
    has no resume fingerprints to check yet."""
    if resume:
        raise NotImplementedError(
            "validate(resume=True): the fingerprint-stability check "
            "(DTA402) needs resume fingerprints, which dampr_tpu_torch "
            "does not have yet")
    diagnostics = []
    records = analyze_stages(graph, probe_traceable=probe_traceable,
                             probe_assoc=probe_assoc,
                             probe_pickle=probe_pickle)
    by_sid = {r["sid"]: r for r in records}
    for sid, stage in enumerate(graph.stages):
        rec = by_sid.get(sid)
        if rec is not None:
            _diagnose_stage(rec, stage, diagnostics)
    # A fold's binop rides both halves of the decomposition (the
    # combiner-carrying map and the final-fold reduce): one user fold,
    # one diagnostic.
    seen_folds = set()
    deduped = []
    for d in diagnostics:
        if d.code in ("DTA101", "DTA102"):
            key = (d.code, tuple(d.evidence))
            if key in seen_folds:
                continue
            seen_folds.add(key)
        deduped.append(d)
    diagnostics = deduped
    if num_processes > 1:
        for d in diagnostics:
            if d.code == "DTA401":
                d.severity = "error"
                d.message = ("unpicklable captured state on a "
                             "multi-process run: dispatch across ranks "
                             "WILL fail — " + d.message)
    order = {s: i for i, s in enumerate(SEVERITIES)}
    diagnostics.sort(key=lambda d: (order[d.severity], d.sid, d.code))
    return diagnostics


def preflight_dispatch_check(graph, num_processes):
    """The dispatch-time promotion: on a multi-process run, an
    unpicklable UDF capture raises :class:`PreflightError` naming the
    stage, the UDF, and the closure variable — replacing the raw
    ``PicklingError`` traceback from deep inside the dispatch.  (The
    port's runner has no multi-process dispatch yet to call it.)"""
    from . import enabled

    if num_processes <= 1 or not enabled():
        return
    errors = [d for d in validate_graph(
        graph, num_processes=num_processes, probe_traceable=False,
        probe_assoc=False) if d.code == "DTA401"]
    if errors:
        raise PreflightError(errors)


def report_section(graph, probe_traceable=False):
    """The plan report's ``analysis`` section (shipped in
    ``stats()["plan"]["analysis"]``).
    Bytecode-only on purpose: the pickle and associativity probes cost
    real work (serialization, sampled evaluation) and belong to the
    explicit ``validate()``/lint surfaces, not every run."""
    records = analyze_stages(graph, probe_traceable=probe_traceable,
                             probe_assoc=False, probe_pickle=False)
    diagnostics = []
    for sid, stage in enumerate(graph.stages):
        rec = next((r for r in records if r["sid"] == sid), None)
        if rec is not None:
            _diagnose_stage(rec, stage, diagnostics)
    return {
        "enabled": True,
        "stages": records,
        "diagnostics": [d.to_dict() for d in diagnostics],
        "counts": {s: sum(1 for d in diagnostics if d.severity == s)
                   for s in SEVERITIES},
    }


def empty_section():
    return {"enabled": False, "stages": [], "diagnostics": [],
            "counts": {s: 0 for s in SEVERITIES}}
