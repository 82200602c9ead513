"""Prometheus text exposition (version 0.0.4) of the metrics plane.

Port of ``dampr_tpu/obs/promtext.py``, whole: dependency-free rendering
of a run's metrics, a live :class:`~.metrics.Metrics` registry or the
``metrics`` section of a ``stats.json``, in the text format every
Prometheus scraper ingests::

    # TYPE dampr_tpu_store_records counter
    dampr_tpu_store_records{run="bench-tfidf"} 1.2345e+06

Dotted engine names (``writer.queue_depth``) flatten to
``dampr_tpu_writer_queue_depth``: the JAX package's names, so one scrape
configuration reads both packages.  Counters export as ``counter``,
sampled gauges as ``gauge`` (the last sample), histograms as a
``_count``/``_sum`` pair plus ``_min``/``_max`` gauges.  The live
``/metrics`` endpoint (:mod:`.serve`) is one :func:`render` of the
active registry.
"""

import re

_PREFIX = "dampr_tpu_"
_BAD = re.compile(r"[^a-zA-Z0-9_]")


def sanitize(name):
    """Dotted engine metric name -> a legal Prometheus metric name."""
    out = _PREFIX + _BAD.sub("_", str(name))
    if out[0].isdigit():
        out = "_" + out
    return out


def escape_label_value(value):
    """Escape a label VALUE per the Prometheus text-format spec
    (exposition formats, version 0.0.4): backslash first (so escapes
    don't double-escape), then double-quote, then line feed as the two
    characters ``\\n`` — a raw newline inside a label would truncate the
    sample line and corrupt the whole exposition."""
    return (str(value).replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(run, rank=None):
    parts = []
    if run:
        parts.append('run="{}"'.format(escape_label_value(run)))
    if rank is not None:
        # Fleet-aware exposition: every sample names its rank, so one
        # Prometheus scraping N ranks' /metrics endpoints can group and
        # diff per-rank series (the tf.data-service per-worker telemetry
        # shape).
        parts.append('rank="{}"'.format(escape_label_value(rank)))
    if not parts:
        return ""
    return "{{{}}}".format(",".join(parts))


def _num(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    return repr(float(v))


def _emit(lines, name, typ, value, run, rank=None):
    lines.append("# TYPE {} {}".format(name, typ))
    lines.append("{}{} {}".format(name, _labels(run, rank), _num(value)))


def render(metrics, rank=None):
    """A live registry -> exposition text (counters, current gauges,
    histogram summaries, sampler self-metrics).  ``rank`` adds the
    per-rank label the live ``/metrics`` endpoint (:mod:`.serve`)
    always sets."""
    summary = metrics.summary()
    # Live gauges beat the last sample: snapshot() pulls callbacks now.
    snap = metrics.snapshot()
    series = {name: {"last": v} for name, v in snap.items()}
    for k, meta in summary.get("series", {}).items():
        series.setdefault(k, {"last": meta.get("last")})
    summary = dict(summary, series={
        k: {"last": v["last"], "samples": 0, "peak": v["last"]}
        for k, v in series.items()})
    return render_summary({"metrics": summary, "run": metrics.run},
                          rank=rank)


def render_summary(stats_summary, rank=None):
    """A persisted stats.json dict (or a fragment with a ``metrics``
    key) -> exposition text.  A run with no metrics section (or an
    empty registry) renders as the EMPTY exposition — zero bytes is the
    valid text-format encoding of "no samples", and scrapers/promtool
    accept it; callers that want to tell the user about it check
    falsiness (the stats CLI does).  ``rank`` defaults from the
    summary's own ``process`` block for multi-process runs, so a
    persisted rank artifact exposes the same labels the live endpoint
    serves."""
    m = stats_summary.get("metrics") or {}
    run = stats_summary.get("run")
    if rank is None:
        proc = stats_summary.get("process") or {}
        if (proc.get("num_processes") or 1) > 1:
            rank = proc.get("process_id", 0)
    lines = []
    counters = m.get("counters") or {}
    series = m.get("series") or {}
    for name in sorted(counters):
        _emit(lines, sanitize(name) + "_total", "counter", counters[name],
              run, rank)
    for name in sorted(series):
        if name in counters:
            continue  # already exported as a counter
        meta = series[name]
        if not isinstance(meta, dict) or "last" not in meta:
            continue
        v = meta["last"]
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        _emit(lines, sanitize(name), "gauge", v, run, rank)
    for name in sorted(m.get("histograms") or {}):
        h = m["histograms"][name]
        base = sanitize(name)
        lines.append("# TYPE {} summary".format(base))
        lines.append("{}_count{} {}".format(base, _labels(run, rank),
                                            _num(h.get("count", 0))))
        lines.append("{}_sum{} {}".format(base, _labels(run, rank),
                                          _num(h.get("sum", 0.0))))
        for k in ("min", "max"):
            if k in h:
                _emit(lines, "{}_{}".format(base, k), "gauge", h[k],
                      run, rank)
    sampler = m.get("sampler") or {}
    for k in ("samples", "series_drops", "overhead"):
        if k in sampler:
            _emit(lines, sanitize("sampler." + k), "gauge", sampler[k],
                  run, rank)
    return "\n".join(lines) + ("\n" if lines else "")
