"""Serialize a run's observability artifacts.

Two files, written side by side under the run's trace directory
(``<scratch_root>/<run>/trace/`` by default, ``settings.trace_dir``
overrides the root), in the JAX package's layout and schema:

- ``trace.json`` — Chrome trace-event format (the JSON Array Format with a
  ``traceEvents`` envelope), loadable in Perfetto (ui.perfetto.dev) or
  chrome://tracing.  Span categories map to event ``cat``; lanes map to
  ``tid`` with ``thread_name`` metadata, so each map slot / codec producer
  / reduce worker / merge generation renders as its own track; the
  metrics plane's series are counter tracks (``"ph":"C"``).
  ``tools/validate_trace.py`` checks it against ``docs/trace_schema.json``.
- ``stats.json`` — the per-run summary (schema ``dampr-tpu-stats/1``),
  the dict ``em.stats()`` returns.
"""

import json
import os
import time

from .. import settings

STATS_SCHEMA = "dampr-tpu-stats/1"
TRACE_FILE = "trace.json"
STATS_FILE = "stats.json"

#: The ``producer`` field of every artifact the port writes.
PRODUCER = "dampr_tpu_torch.obs"


def run_trace_dir(run_name):
    """Where a run's artifacts live: ``<root>/<run>/trace/`` beside the
    run's spill directory (the JAX package's rank-0 layout: the port runs
    as one process)."""
    safe = run_name.replace("/", "_")
    root = settings.trace_dir or settings.scratch_root
    return os.path.join(root, safe, "trace")


def process_section():
    """The ``process`` block stamped into every artifact: the port runs as
    one process, rank 0 of 1."""
    return {"process_id": 0, "num_processes": 1}


def chrome_events(tracer):
    """A Tracer's compact event tuples as Chrome trace events."""
    pid = 1
    out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "dampr_tpu_torch:{}".format(tracer.run)}}]
    # Stable small tids: Perfetto sorts tracks by tid, so lanes number in
    # first-seen order instead of leaking thread idents.
    tid_of = {}
    for lane, lname in tracer.lane_names.items():
        tid = tid_of.setdefault(lane, len(tid_of) + 1)
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": lname}})
    for cat, name, t0, dur, lane, args in tracer.events:
        tid = tid_of.setdefault(lane, len(tid_of) + 1)
        ev = {"name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": round(t0 * 1e6, 3)}
        if dur is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(dur * 1e6, 3)
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def counter_events(metrics, pid=1):
    """Metrics time series as Chrome counter-track events (``"ph":"C"``),
    one per (series, sample).  Timestamps are the sampler's, relative to
    the metrics epoch, which the runner points at the tracer's, so both
    clocks agree in one file; a sample before that epoch is clamped to 0
    (a negative timestamp breaks the track and the schema)."""
    out = []
    with metrics._mu:
        series = {name: list(s) for name, s in metrics.series.items()}
    for name in sorted(series):
        for t, v in series[name]:
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            out.append({"ph": "C", "name": name, "cat": "metric",
                        "pid": pid, "tid": 0,
                        "ts": max(0.0, round(t * 1e6, 3)),
                        "args": {"value": v}})
    return out


def write_trace(tracer, path, metrics=None):
    events = chrome_events(tracer)
    if metrics is not None:
        events.extend(counter_events(metrics))
    proc = process_section()
    proc["epoch_perf"] = tracer.epoch
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run": tracer.run,
            "wall_start": tracer.wall_start,
            "producer": PRODUCER,
            "process": proc,
        },
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def write_stats(summary, path):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path


def locate_stats(run):
    """Resolve a run name / run directory / stats.json path to the stats
    file, or None."""
    cands = []
    if os.path.isfile(run):
        cands.append(run)
    if os.path.isdir(run):
        cands.append(os.path.join(run, STATS_FILE))
        cands.append(os.path.join(run, "trace", STATS_FILE))
    cands.append(os.path.join(run_trace_dir(run), STATS_FILE))
    for c in cands:
        if os.path.isfile(c):
            return c
    return None


def load_stats(run):
    """(summary dict, path) for a run name/dir/file, or (None, None)."""
    path = locate_stats(run)
    if path is None:
        return None, None
    with open(path) as f:
        return json.load(f), path


def _mb(n):
    return "{:.1f} MB".format(n / 1e6)


def format_summary(summary):
    """Human-readable rendering of a stats.json summary."""
    lines = []
    add = lines.append
    add("run: {}  ({:.2f}s wall, {} stages)".format(
        summary.get("run", "?"), summary.get("wall_seconds", 0.0),
        len(summary.get("stages", []))))
    started = summary.get("started_at")
    if started:
        add("started: {}".format(
            time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(started))))
    add("")
    add("{:>5} {:<12} {:>5} {:>12} {:>12} {:>10} {:>10} {:>10} {:>8}".format(
        "stage", "kind", "jobs", "rec_in", "rec_out", "bytes_in",
        "bytes_out", "spill", "secs"))
    for st in summary.get("stages", []):
        add("{:>5} {:<12} {:>5} {:>12} {:>12} {:>10} {:>10} {:>10} {:>8}"
            .format(st.get("stage", "?"), st.get("kind", "?"),
                    st.get("jobs", 0), st.get("records_in", 0),
                    st.get("records_out", 0), _mb(st.get("bytes_in", 0)),
                    _mb(st.get("bytes_out", 0)),
                    _mb(st.get("spill_bytes", 0)),
                    "{:.2f}".format(st.get("seconds", 0.0))))
    plan = summary.get("plan") or {}
    if plan:
        fired = {k: v for k, v in sorted((plan.get("rules") or {}).items())
                 if v}
        line = "plan: {} -> {} stages".format(
            plan.get("stages_before", "?"), plan.get("stages_after", "?"))
        if fired:
            line += "  ({})".format(", ".join(
                "{}={}".format(k, v) for k, v in fired.items()))
        add(line)
    store = summary.get("store", {})
    add("")
    add("spill: {} blocks / {}  ·  merge generations: {} ({})".format(
        store.get("spill_count", 0), _mb(store.get("spilled_bytes", 0)),
        store.get("merge_gens", 0), _mb(store.get("merge_gen_bytes", 0))))
    io = summary.get("io", {})
    if io.get("spill_write_bytes") or io.get("spill_read_bytes"):
        line = ("spill io: wrote {} @ {:.0f} MB/s · read {} @ {:.0f} MB/s "
                "· io_wait {:.2f}s ({:.1%} of wall)".format(
                    _mb(io.get("spill_write_bytes", 0)),
                    io.get("spill_write_mbps", 0.0),
                    _mb(io.get("spill_read_bytes", 0)),
                    io.get("spill_read_mbps", 0.0),
                    io.get("io_wait_seconds", 0.0),
                    io.get("io_wait_fraction", 0.0)))
        if io.get("writer_queue_peak"):
            line += " · writer queue peak {}".format(
                io["writer_queue_peak"])
        add(line)
    met = summary.get("metrics")
    if met:
        sm = met.get("sampler", {})
        add("metrics: {} samples @ {} ms · {} series · drops {} · "
            "sampler overhead {:.2%}".format(
                sm.get("samples", 0), sm.get("interval_ms", 0),
                len(met.get("series", {})), sm.get("series_drops", 0),
                sm.get("overhead", 0.0)))
    if store.get("h2d_bytes") or store.get("hbm_offloads"):
        add("HBM tier: {} up, {} fetched back, {} offloads, peak {}".format(
            _mb(store.get("h2d_bytes", 0)), _mb(store.get("d2h_bytes", 0)),
            store.get("hbm_offloads", 0), _mb(store.get("hbm_peak_bytes",
                                                        0))))
    devx = summary.get("device", {})
    if devx.get("device_stages") or devx.get("device_fraction"):
        add("device: {} lowered stage(s) · device_fraction {:.2f} · "
            "h2d {} · d2h {}".format(
                devx.get("device_stages", 0),
                devx.get("device_fraction", 0.0),
                _mb(devx.get("h2d_bytes", 0)),
                _mb(devx.get("d2h_bytes", 0))))
    dev = summary.get("devtime", {})
    if dev:
        add("devtime: device {:.2f}s · transfer {:.2f}s · codec {:.2f}s "
            "(non-overlapped {:.2f}s)".format(
                dev.get("device", 0.0), dev.get("transfer", 0.0),
                dev.get("codec", 0.0), dev.get("codec_wait", 0.0)))
    ov = summary.get("overlap", {})
    if ov:
        add("overlap: windows={} stall_fraction={:.3f}".format(
            ov.get("windows", 0), ov.get("stall_fraction", 0.0)))
    if summary.get("retries"):
        add("job retries: {}".format(summary["retries"]))
    spans = summary.get("spans")
    if spans:
        add("")
        add("span kinds: " + ", ".join(
            "{} ({}x, {:.2f}s)".format(cat, v.get("count", 0),
                                       v.get("seconds", 0.0))
            for cat, v in sorted(spans.items())))
    tf = summary.get("trace_file")
    add("")
    if tf:
        add("trace: {}  (load in https://ui.perfetto.dev or "
            "chrome://tracing)".format(tf))
    else:
        add("trace: none (enable with settings.trace / "
            "DAMPR_TPU_TORCH_TRACE=1)")
    return "\n".join(lines)
