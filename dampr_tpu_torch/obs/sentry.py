"""Regression sentry: MAD anomaly detection over the telemetry store.

Port of ``dampr_tpu/obs/sentry.py``, whole.  A quiet regression (a
setting that drifted, a slower codec, a stage that fell off the card)
shows as the newest telemetry point (:mod:`.timeseries`) drifting from
the earlier points of its plan fingerprint.  The sentry judges it with
the robust z-score::

    med   = median(baseline)                  # trailing window
    mad   = median(|x - med|)                 # median absolute deviation
    scale = 1.4826 * mad                      # ~sigma for normal data
    z     = (value - med) / scale

The median and the MAD shrug off one noisy point in a small window where
a mean and a standard deviation would not.  A flat baseline (MAD 0)
falls back to ``scale = max(|med| * 0.05, 1e-9)``, so a new nonzero
value still trips and equal values never do.  Each metric is judged in
its bad direction only (``timeseries.METRICS``): a faster run never
alarms.

A metric needs :data:`MIN_BASELINE` comparable points before it is
judged.  The runner's finalize hook runs the sentry warn-only; the CLI's
``--strict`` turns a finding into exit code 2.
"""

import json
import logging
import statistics

from .. import settings
from . import timeseries as _timeseries

log = logging.getLogger("dampr_tpu_torch.obs.sentry")

#: Least comparable baseline points before the sentry judges a metric.
MIN_BASELINE = 3

#: metric -> (knob, environment variable, why): the dial a finding names
#: for its metric.  Every knob is one of the port's
#: (``history.knob_value`` reads it); None where it has no variable.
METRIC_KNOBS = {
    "wall_seconds": (
        "max_memory_per_stage", "DAMPR_TPU_TORCH_MEMORY_BUDGET",
        "wall time regressions usually track spill/eviction pressure; "
        "check the stage memory budget first"),
    "mbps": (
        "overlap_windows", "DAMPR_TPU_TORCH_OVERLAP_WINDOWS",
        "throughput drops when the producer lookahead stops covering "
        "consumer stalls"),
    "spill_bytes": (
        "max_memory_per_stage", "DAMPR_TPU_TORCH_MEMORY_BUDGET",
        "growing spill volume means the working set stopped fitting the "
        "stage budget"),
    "retries": (
        "io_retries", "DAMPR_TPU_TORCH_IO_RETRIES",
        "rising retry absorption points at a degrading disk/codec; the "
        "retry budget is masking it"),
    "quarantined": (
        "max_quarantined", "DAMPR_TPU_TORCH_MAX_QUARANTINED",
        "more quarantined partitions means more data silently excluded "
        "from results"),
    "reuse_hit_rate": (
        "reuse_budget_bytes", "DAMPR_TPU_TORCH_REUSE_BUDGET",
        "falling cross-run cache yield — the reuse budget may be "
        "evicting still-hot prefixes"),
    "device_fraction": (
        "lower", "DAMPR_TPU_TORCH_LOWER",
        "compute is sliding off the accelerator back onto host fallback "
        "paths"),
    "handoff_fraction": (
        "handoff", "DAMPR_TPU_TORCH_HANDOFF",
        "stage boundaries stopped staying device-resident and are "
        "round-tripping through host spill"),
}


def effective_window():
    return max(0, settings.sentry_window)


def effective_threshold():
    return settings.sentry_mad_threshold


def detect(points, window=None, threshold=None):
    """Judge the NEWEST point of one fingerprint series (oldest first)
    against the ``window`` points before it.  Returns one finding dict
    per regressed metric, largest ``|z|`` first::

        {metric, value, median, mad, z, threshold, window, direction,
         run, ts, fingerprint, setting, env, why}
    """
    window = effective_window() if window is None else window
    threshold = effective_threshold() if threshold is None else threshold
    if len(points) < 2 or window <= 0 or threshold <= 0:
        return []
    newest = points[-1]
    trailing = points[:-1][-window:]
    findings = []
    for metric, direction in _timeseries.METRICS.items():
        value = newest.get(metric)
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        baseline = [p[metric] for p in trailing
                    if isinstance(p.get(metric), (int, float))
                    and not isinstance(p.get(metric), bool)]
        if len(baseline) < MIN_BASELINE:
            continue
        med = statistics.median(baseline)
        mad = statistics.median(abs(x - med) for x in baseline)
        scale = 1.4826 * mad
        if scale <= 0:
            # flat baseline: 5% of the median is one unit of z, with a
            # floor so an all-zero baseline can still be judged
            scale = max(abs(med) * 0.05, 1e-9)
        z = (value - med) / scale
        bad = z > threshold if direction == "high" else z < -threshold
        if not bad:
            continue
        knob = METRIC_KNOBS.get(metric)
        findings.append({
            "metric": metric,
            "value": value,
            "median": med,
            "mad": mad,
            "z": round(z, 2),
            "threshold": threshold,
            "window": len(baseline),
            "direction": direction,
            "run": newest.get("run"),
            "ts": newest.get("ts"),
            "fingerprint": newest.get("fingerprint"),
            "setting": knob[0] if knob else None,
            "env": knob[1] if knob else None,
            "why": knob[2] if knob else None,
        })
    findings.sort(key=lambda f: -abs(f["z"]))
    return findings


def _points(run_name):
    """The run's telemetry points, folded from its history corpus first
    when the store is missing but a corpus exists."""
    points = _timeseries.load(run_name)
    if not points:
        from . import history as _hist

        if _hist.load(run_name):
            _timeseries.fold(run_name)
            points = _timeseries.load(run_name)
    return points


def check_run(run_name, summary=None, window=None, threshold=None):
    """The sentry's findings for a run name's NEWEST telemetry point (the
    one the runner just appended), judged within ``summary``'s plan
    fingerprint when given, else the newest point's.  Never raises; no
    data gives no findings."""
    try:
        points = _points(run_name)
        if not points:
            return []
        fp = None
        if summary is not None:
            from . import history as _hist

            fp = _hist.plan_fingerprint(
                (summary.get("plan") or {}).get("stage_shapes") or [])
        if fp is None:
            fp = points[-1].get("fingerprint")
        series = _timeseries.series(points, fingerprint=fp)
        return detect(series, window=window, threshold=threshold)
    except Exception:
        log.debug("sentry check failed for %r", run_name, exc_info=True)
        return []


def format_findings(findings):
    """Human lines for a findings list (the CLI's and the doctor's)."""
    out = []
    for f in findings:
        arrow = "above" if f["direction"] == "high" else "below"
        out.append("REGRESSION {metric}: {value:g} is {z:+.1f} robust "
                   "sigma {arrow} the baseline median {median:g} "
                   "(window={window} run(s), run={run})".format(
                       arrow=arrow, **f))
        if f.get("setting"):
            out.append("  knob: settings.{setting} ({env}) — {why}".format(
                **f))
    return out


def main(argv=None):
    """Judge a run's newest telemetry point.

    Warn-only by default (exit 0, findings printed); ``--strict`` exits 2
    when a metric regressed.  Exit 1: the run has no telemetry and no
    history corpus.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli sentry",
        description="regression sentry over dampr_tpu_torch run telemetry")
    p.add_argument("run", help="run name (scratch-root corpus key)")
    p.add_argument("--strict", action="store_true",
                   help="exit nonzero when a regression is detected")
    p.add_argument("--json", action="store_true", help="machine output")
    p.add_argument("--window", type=int, default=None,
                   help="baseline window (default: settings.sentry_window"
                        " = DAMPR_TPU_TORCH_SENTRY_WINDOW)")
    p.add_argument("--threshold", type=float, default=None,
                   help="robust z threshold (default: settings."
                        "sentry_mad_threshold = DAMPR_TPU_TORCH_SENTRY_MAD)")
    p.add_argument("--fingerprint", metavar="F", default=None,
                   help="judge this plan-shape series instead of the "
                        "newest point's")
    p.add_argument("--fold", action="store_true",
                   help="rebuild the telemetry store from the history "
                        "corpus first")
    args = p.parse_args(argv)

    if args.fold:
        n = _timeseries.fold(args.run)
        print("folded {} point(s) from the history corpus".format(n))
    points = _points(args.run)
    if not points:
        print("no telemetry for run {!r} under {} (and no history "
              "corpus to fold)".format(args.run, settings.scratch_root))
        return 1

    fp = args.fingerprint or points[-1].get("fingerprint")
    series = _timeseries.series(points, fingerprint=fp)
    findings = detect(series, window=args.window, threshold=args.threshold)
    threshold = (args.threshold if args.threshold is not None
                 else effective_threshold())

    if args.json:
        print(json.dumps({
            "run": args.run,
            "fingerprint": fp,
            "points": len(series),
            "window": (args.window if args.window is not None
                       else effective_window()),
            "threshold": threshold,
            "findings": findings,
        }, indent=2, sort_keys=True))
    else:
        print("sentry: run={} fingerprint={} series={} point(s)".format(
            args.run, fp, len(series)))
        if findings:
            for line in format_findings(findings):
                print(line)
        elif len(series) <= MIN_BASELINE:
            print("baseline too thin to judge "
                  "(need >{} comparable points)".format(MIN_BASELINE))
        else:
            print("no regression: newest point within {:g} robust sigma "
                  "of its baseline".format(threshold))
    if findings and args.strict:
        return 2
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
