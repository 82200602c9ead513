"""The port's command-line tools: ``python -m dampr_tpu_torch.cli <name> ...``.

Port of ``dampr_tpu/cli.py``.  The JAX package installs one console
script per tool; the port has one module and picks the tool by its first
argument (no console scripts: ``python -m`` needs no install):

- ``bench``   — the TF-IDF benchmark (:mod:`.bench_tfidf`;
  ``DAMPR_BENCH_MB`` sizes the corpus), one JSON line on stdout.
- ``wc``      — word count over a file or directory, the top 20.
- ``tfidf``   — TF-IDF over a file or directory, TSV parts to ``--out``.
- ``stats``   — a finished run's ``stats.json``, pretty-printed, and where
  its trace is; ``--series`` renders the sampled series, ``--prom`` the
  Prometheus text, ``--log`` the newest structured events.  A run that
  left a crashdump (on any rank) exits 3.  ``--fleet`` merges a
  multi-process run's per-rank traces and prints the fleet section.
- ``doctor``  — ranked bottleneck diagnosis (:mod:`.obs.doctor`);
  ``--diff``, ``--json``, ``--autotune``.
- ``lint``    — static pre-flight diagnostics (:mod:`.analyze.lint`).
- ``sentry``  — the regression sentry (:mod:`.obs.sentry`).
- ``top``     — the live dashboard over ``/metrics`` (:mod:`.obs.top`).
- ``history`` — the run-history corpora (:mod:`.obs.history`).
- ``serve``   — the serve daemon (:mod:`.serve.daemon`).

Every tool runs on ``settings.device`` ("cuda" by default;
``DAMPR_TPU_TORCH_DEVICE=cpu`` for the CPU).  ``wc`` and ``tfidf`` take
``--progress`` (the live status line) and ``--explain`` (the optimized
plan, without running).
"""

import argparse
import math
import operator
import os
import sys

#: The variable that names a multi-process deployment's coordinator.
COORDINATOR_ENV = "DAMPR_TPU_TORCH_COORDINATOR"


def _join_deployment():
    """Join the process group the environment names (a coordinator in
    ``DAMPR_TPU_TORCH_COORDINATOR``, with ``..._NUM_PROCESSES`` and
    ``..._PROCESS_ID``), so a tool dropped onto a rank spans every rank's
    shards; nothing without a coordinator.  An incomplete deployment
    exits 2 (never a silent run as one process); a failed join raises."""
    from .parallel.mesh import maybe_init_distributed

    try:
        maybe_init_distributed()
    except ValueError as e:
        print("{} is set, but {}".format(COORDINATOR_ENV, e),
              file=sys.stderr)
        raise SystemExit(2)


def bench(argv=None):
    """The TF-IDF benchmark (:func:`.bench_tfidf.main`)."""
    argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli bench",
        description="the TF-IDF benchmark: DAMPR_BENCH_MB sizes the "
                    "corpus, DAMPR_BENCH_DIR holds it").parse_args(argv)
    _join_deployment()
    from .bench_tfidf import main

    main()
    return 0


def _print_stats(emitter):
    from .obs import export

    print()
    print(export.format_summary(emitter.stats()))


def _run_args(description, argv, *extra):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("path")
    for args, kw in extra:
        ap.add_argument(*args, **kw)
    ap.add_argument("--stats", action="store_true",
                    help="print the run's stage/spill/devtime summary")
    ap.add_argument("--progress", action="store_true",
                    help="live per-stage status line while the run "
                         "executes (records/s, MB/s, spill backlog, ETA)")
    ap.add_argument("--explain", action="store_true",
                    help="print the optimized logical plan (stage fusion, "
                         "dead stages, adaptive sizing) and exit without "
                         "running")
    args = ap.parse_args(argv)
    from . import settings

    if args.progress:
        settings.progress = True
    _join_deployment()
    settings.resolve_device()
    return args


def wc(argv=None):
    """Word count over a file or directory: the top 20 words."""
    args = _run_args("word count (top 20)", argv,
                     (("--chunk-mb",), {"type": int, "default": 16}))
    from . import Dampr

    pipe = (Dampr.text(args.path, chunk_size=args.chunk_mb * 1024 ** 2)
            .flat_map(lambda line: line.split())
            .fold_by(lambda w: w, binop=operator.add, value=lambda w: 1))
    if args.explain:
        print(pipe.explain(name="wc-cli"))
        return 0
    counts = pipe.run("wc-cli")
    for word, count in sorted(counts, key=lambda kv: kv[1],
                              reverse=True)[:20]:
        print("{}: {}".format(word, count))
    if args.stats:
        _print_stats(counts)
    counts.delete()
    return 0


def tf_idf(argv=None):
    """TF-IDF over a file or directory, TSV parts to ``--out``."""
    import tempfile

    args = _run_args(
        "TF-IDF -> TSV parts", argv,
        (("--out",), {"default": os.path.join(tempfile.gettempdir(),
                                              "dampr_tpu_torch_idfs")}))
    from . import Dampr
    from .ops.text import DocFreq

    chunk = (os.path.getsize(args.path) + 1
             if os.path.isfile(args.path) else 16 * 1024 ** 2)
    docs = Dampr.text(args.path, chunk)
    df = (docs.custom_mapper(DocFreq(mode="word", lower=True))
          .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))
    idf = df.cross_right(
        docs.len(),
        lambda d, total: (d[0], d[1], math.log(1 + float(total) / d[1])),
        memory=True)
    pipe = idf.sink_tsv(args.out)
    if args.explain:
        print(pipe.explain(name="tfidf-cli"))
        return 0
    em = pipe.run("tfidf-cli")
    print("TSV parts in {}".format(args.out))
    if args.stats:
        _print_stats(em)
    return 0


def doctor(argv=None):
    """Ranked bottleneck diagnosis of a finished run."""
    from .obs.doctor import main

    return main(argv)


def lint(argv=None):
    """Static pre-flight diagnostics of pipeline modules."""
    from .analyze.lint import main

    return main(argv)


def sentry(argv=None):
    """The regression sentry over a run's telemetry."""
    from .obs.sentry import main

    return main(argv)


def top(argv=None):
    """The live dashboard over the per-rank ``/metrics`` endpoints."""
    from .obs.top import main

    return main(argv)


def history_cli(argv=None):
    """Inspect and maintain the run-history corpora."""
    from .obs.history import main

    return main(argv)


def serve(argv=None):
    """The multi-tenant serve daemon (:mod:`.serve`)."""
    from .serve.daemon import main

    return main(argv)


def _report_crashdump(dump):
    """Describe a flight-recorder crash dump on stderr (why the exit code
    is not 0)."""
    import json

    line = "CRASHED RUN: crashdump at {}".format(dump)
    try:
        with open(dump) as f:
            other = json.load(f).get("otherData") or {}
        crash = other.get("crash") or {}
        proc = other.get("process") or crash or {}
        if (proc.get("num_processes") or 1) > 1:
            line += "  [rank {}/{}]".format(proc.get("process_id", "?"),
                                            proc.get("num_processes"))
        if crash.get("reason"):
            line += "  (reason: {}".format(crash["reason"])
            if crash.get("exception"):
                line += ", {}: {}".format(crash["exception"],
                                          crash.get("message", ""))
            line += ")"
    except (OSError, ValueError):
        pass
    print(line, file=sys.stderr)


def _series_view(summary, path, run):
    tf = summary.get("trace_file")
    if not tf or not os.path.isfile(tf):
        # the trace (or crash dump) beside the stats file: trace_dir may
        # have moved since the run
        for cand in ("trace.json", "crashdump.json"):
            c = os.path.join(os.path.dirname(path), cand)
            if os.path.isfile(c):
                tf = c
                break
    from .obs import export

    if not tf or not os.path.isfile(tf):
        print("no trace.json for {!r}: the time series live there as "
              "counter events".format(run), file=sys.stderr)
    else:
        print()
        print(export.format_series(export.load_series(tf)))
    pipe_view = export.format_pipeline_series(summary)
    if pipe_view:
        print()
        print(pipe_view)


def stats(argv=None):
    """A finished run's ``stats.json`` (written when ``settings.trace`` /
    ``DAMPR_TPU_TORCH_TRACE=1`` was on), pretty-printed.  Exit 3 when the
    run left a flight-recorder ``crashdump.json``, 2 when it left
    nothing."""
    ap = argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli stats",
        description="pretty-print a run's stats.json + trace location")
    ap.add_argument("run", help="run name (as passed to run(name=...)), a "
                                "run scratch directory, or a stats.json "
                                "path")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw stats.json instead of formatting")
    ap.add_argument("--series", action="store_true",
                    help="render the sampled metric time series (counter "
                         "events from the run's trace.json/crashdump.json)")
    ap.add_argument("--prom", action="store_true",
                    help="dump the run's metrics in Prometheus text "
                         "exposition format")
    ap.add_argument("--fleet", action="store_true",
                    help="merge a multi-process run's per-rank traces "
                         "into one Perfetto timeline and print the fleet "
                         "section (per-rank totals, exchange matrices, "
                         "per-step skew, straggler)")
    ap.add_argument("--log", nargs="?", const=20, type=int, default=None,
                    metavar="N",
                    help="render the newest N structured log events "
                         "(default 20) from the run's events.jsonl "
                         "(settings.log_level / DAMPR_TPU_TORCH_LOG)")
    args = ap.parse_args(argv)

    from .obs import export, flightrec

    summary, path = export.load_stats(args.run)
    # every rank's crashdump: a clean rank 0 must not hide a dead sibling
    dumps = flightrec.locate_all_crashdumps(args.run)
    dump = dumps[0] if dumps else None
    if summary is None:
        if dump is not None:
            # a run that died before its stats landed still left its
            # crash timeline: name it and fail
            for d in dumps:
                _report_crashdump(d)
            return 3
        print("no stats.json found for {!r} (searched under {}); traced "
              "runs write one — enable settings.trace / "
              "DAMPR_TPU_TORCH_TRACE=1".format(
                  args.run, export.run_trace_dir(args.run)),
              file=sys.stderr)
        return 2
    if args.fleet and summary.get("fleet") is None:
        # merge afterwards, before any output mode renders (the ranks'
        # artifacts may have landed after rank 0 finished; merging is
        # idempotent, and --json embeds the section)
        from .obs import fleet

        section = fleet.merge_run(os.path.dirname(path) if path
                                  else args.run)
        if section is not None:
            summary["fleet"] = section
    log_tail = None
    if args.log is not None:
        from .obs import log as obslog

        cand = os.path.join(os.path.dirname(path), obslog.FILE)
        log_tail = obslog.tail(cand if os.path.isfile(cand) else args.run,
                               n=args.log)
        if args.json:
            summary = dict(summary, log_tail=log_tail)
    if args.prom:
        from .obs import promtext

        out = promtext.render_summary(summary)
        if not out:
            print("no metrics section in {} (enable the metrics plane: "
                  "settings.metrics_interval_ms / "
                  "DAMPR_TPU_TORCH_METRICS_MS)".format(path),
                  file=sys.stderr)
        else:
            sys.stdout.write(out)
    elif args.json:
        import json

        print(json.dumps(summary, indent=2, sort_keys=True))
    else:
        print("stats: {}".format(path))
        print(export.format_summary(summary))
    if (not args.prom and not args.json and dump is None
            and summary.get("critpath")):
        run_verdict = (summary["critpath"].get("run") or {}).get("verdict")
        if run_verdict:
            print("bottleneck: {}  (run `python -m dampr_tpu_torch.cli "
                  "doctor {}` for the full diagnosis)".format(
                      run_verdict, args.run))
    if args.fleet and not args.json and not args.prom:
        from .obs import fleet

        print()
        print(fleet.format_fleet(summary.get("fleet")))
    if args.series:
        _series_view(summary, path, args.run)
    if args.log is not None and not args.json and not args.prom:
        from .obs import log as obslog

        print()
        print(obslog.format_tail(log_tail))
    if dump is not None:
        for d in dumps:
            _report_crashdump(d)
        return 3
    return 0


#: The tools, by the name ``main`` takes as its first argument.
COMMANDS = {
    "bench": bench,
    "wc": wc,
    "tfidf": tf_idf,
    "stats": stats,
    "doctor": doctor,
    "lint": lint,
    "sentry": sentry,
    "top": top,
    "history": history_cli,
    "serve": serve,
}


def main(argv=None):
    """Run the tool its first argument names; returns its exit code."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print("usage: python -m dampr_tpu_torch.cli {{{}}} ...".format(
            ",".join(COMMANDS)), file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
