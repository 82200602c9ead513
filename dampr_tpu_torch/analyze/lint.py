"""Pre-flight pipeline diagnostics from the shell (port of
``dampr_tpu/analyze/lint.py``)::

    python -m dampr_tpu_torch.analyze.lint [--json] [--strict]
        [--processes N] TARGET...

Lints the pipelines a Python module *constructs* — no pipeline runs.
(One deliberate exception to "static": a fold binop the classifier
finds *pure* is probed for associativity by executing it on a few
synthetic int/float/str triples; impure binops are never executed.)
Two discovery modes, in priority order:

1. the module defines ``lint_pipelines()`` returning an iterable of
   pipeline handles (or ``(name, handle)`` pairs);
2. otherwise, every pipeline handle the module constructed at import
   time is discovered through the DSL's live-handle registry, reduced
   to the *maximal* handles (one whose source no other discovered
   graph consumes — intermediates are prefixes of their consumers and
   would only duplicate diagnostics).

Each pipeline runs the FULL probe set of :func:`..validate.validate_graph`
(bytecode classification + serialization probe + randomized
associativity probe + traceability probe) regardless of
``settings.analyze`` — invoking the linter is its own opt-in.

Exit codes: 0 = clean (or only warn/info without ``--strict``), 1 = any
error-severity diagnostic (with ``--strict``: any warning too), 2 =
import failure or no pipelines found.  ``--json`` emits the machine
report (schema ``dampr-tpu-lint/1``, docs/lint_schema.json, validated
by ``tools/validate_lint.py``), the JAX package's schema.  The JAX
package's ``--resume`` check (``DTA402``) waits for the port's resume
fingerprints.
"""

import argparse
import importlib
import importlib.util
import json
import os
import re
import sys

SCHEMA = "dampr-tpu-lint/1"


def _import_target(target):
    """Import a lint target: a ``.py`` path or a dotted module name."""
    if os.path.exists(target):
        path = os.path.abspath(target)
        mod_name = "_dampr_lint_" + re.sub(
            r"\W", "_", os.path.splitext(os.path.basename(path))[0])
        d = os.path.dirname(path)
        sys.path.insert(0, d)
        try:
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
        finally:
            try:
                sys.path.remove(d)
            except ValueError:
                pass
        return mod
    return importlib.import_module(target)


def _maximal_handles(handles):
    """Drop handles whose source another discovered graph consumes —
    they are construction prefixes of their consumers."""
    consumed = set()
    for h in handles:
        for stage in h.pmer.graph.stages:
            consumed.update(getattr(stage, "inputs", ()))
    return [h for h in handles if h.source not in consumed]


def collect_pipelines(target):
    """``[(name, handle)]`` for one lint target (see module docstring)."""
    from .. import dampr as _dampr

    before = set(_dampr._live_handles)
    mod = _import_target(target)
    hook = getattr(mod, "lint_pipelines", None)
    if callable(hook):
        out = []
        for i, item in enumerate(hook()):
            if isinstance(item, tuple) and len(item) == 2:
                out.append((str(item[0]), item[1]))
            else:
                out.append(("pipeline{}".format(i), item))
        return out
    fresh = [h for h in set(_dampr._live_handles) - before]
    maximal = _maximal_handles(fresh)
    # Stable order: by construction (stage count, then repr) — sets have
    # no order and lint output must be diffable.
    maximal.sort(key=lambda h: (len(h.pmer.graph.stages), repr(h.source)))
    return [("pipeline{}".format(i), h) for i, h in enumerate(maximal)]


def lint_target(target, num_processes=1):
    """Lint one module: ``(target_record, [diagnostic_dict])``."""
    rec = {"target": str(target), "pipelines": [], "error": None}
    try:
        pipelines = collect_pipelines(target)
    except Exception as e:  # import errors are the result — but Ctrl-C /
        #                     SystemExit must still abort the whole run
        rec["error"] = "{}: {}".format(type(e).__name__, str(e)[:300])
        return rec, []
    diagnostics = []
    seen = set()
    for name, handle in pipelines:
        rec["pipelines"].append(name)
        for d in handle.validate(num_processes=num_processes):
            dd = d.to_dict()
            # Shared prefixes across one module's pipelines produce the
            # same diagnostic once per consumer — dedupe on content.
            key = (dd["code"], dd["stage"], dd["message"],
                   tuple(dd["evidence"]))
            if key in seen:
                continue
            seen.add(key)
            dd["pipeline"] = name
            diagnostics.append(dd)
    return rec, diagnostics


def _counts(diagnostics):
    from .validate import SEVERITIES

    return {s: sum(1 for d in diagnostics if d["severity"] == s)
            for s in SEVERITIES}


def run_lint(targets, num_processes=1, strict=False):
    """The whole-invocation report dict (docs/lint_schema.json)."""
    target_recs = []
    diagnostics = []
    failed = False
    for t in targets:
        rec, diags = lint_target(t, num_processes=num_processes)
        target_recs.append(rec)
        diagnostics.extend(diags)
        if rec["error"] is not None or not rec["pipelines"]:
            failed = True
    counts = _counts(diagnostics)
    if failed:
        exit_code = 2
    elif counts["error"] or (strict and counts["warn"]):
        exit_code = 1
    else:
        exit_code = 0
    return {
        "schema": SCHEMA,
        "targets": target_recs,
        "diagnostics": diagnostics,
        "counts": counts,
        "strict": bool(strict),
        "exit_code": exit_code,
    }


def _render(report):
    lines = []
    for rec in report["targets"]:
        if rec["error"] is not None:
            lines.append("{}: IMPORT FAILED: {}".format(
                rec["target"], rec["error"]))
        elif not rec["pipelines"]:
            lines.append("{}: no pipelines found (define "
                         "lint_pipelines() or construct handles at "
                         "import time)".format(rec["target"]))
        else:
            lines.append("{}: {} pipeline(s): {}".format(
                rec["target"], len(rec["pipelines"]),
                ", ".join(rec["pipelines"])))
    for d in report["diagnostics"]:
        lines.append("{}: {} [{} s{}: {}] {}".format(
            d["severity"], d["code"], d["pipeline"], d["sid"],
            d["stage"], d["message"]))
        for e in d["evidence"]:
            lines.append("    - " + e)
    c = report["counts"]
    lines.append("lint: {} error(s), {} warning(s), {} info".format(
        c["error"], c["warn"], c["info"]))
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dampr_tpu_torch.analyze.lint",
        description="static pre-flight diagnostics for dampr_tpu_torch "
                    "pipelines (docs/analysis.md)")
    ap.add_argument("targets", nargs="+",
                    help="Python files (or dotted module names) that "
                         "construct pipelines at import time or define "
                         "lint_pipelines()")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine report "
                         "(schema dampr-tpu-lint/1)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on warnings too, not only errors")
    ap.add_argument("--processes", type=int, default=1, metavar="N",
                    help="lint as if dispatching across N ranks "
                         "(promotes unpicklable captures to errors)")
    args = ap.parse_args(argv)
    report = run_lint(args.targets, num_processes=args.processes,
                      strict=args.strict)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(_render(report))
    return report["exit_code"]


if __name__ == "__main__":
    sys.exit(main())
