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


def run_trace_dir(run_name, rank=None):
    """Where a run's artifacts live: ``<root>/<run>/trace/`` beside the
    run's spill directory.  A multi-process run writes per rank: rank 0
    keeps ``<run>/trace/``, rank k writes ``<run>/trace/rank<k>/``.
    ``rank=None`` is this process's rank
    (:func:`..parallel.mesh.rank_info`, which touches no device)."""
    safe = run_name.replace("/", "_")
    root = settings.trace_dir or settings.scratch_root
    base = os.path.join(root, safe, "trace")
    if rank is None:
        from ..parallel.mesh import rank_info

        rank = rank_info()[0]
    if rank and rank > 0:
        return os.path.join(base, "rank{}".format(int(rank)))
    return base


def process_section():
    """The ``process`` block stamped into every artifact (stats.json,
    trace otherData, crashdumps, history records): the rank and the
    ranks; once a process group is up, the global and local shard counts
    (the fleet's shard -> rank map) and the clock handshake's anchor,
    which the fleet merge aligns the ranks' timelines on."""
    from ..parallel import mesh

    pid, n = mesh.rank_info()
    sec = {"process_id": pid, "num_processes": n}
    if mesh.is_initialized():
        local = len(settings._mesh_entries())
        sec["global_devices"] = local * n
        sec["local_devices"] = local
    if mesh.clock_sync is not None:
        sec["clock"] = dict(mesh.clock_sync)
    return sec


def chrome_events(tracer):
    """A Tracer's compact event tuples as Chrome trace events."""
    pid = 1
    out = [{"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "dampr_tpu_torch:{}".format(tracer.run)}}]
    tid_of = _lane_tids(tracer)
    for lane, lname in tracer.lane_names.items():
        out.append({"ph": "M", "pid": pid, "tid": tid_of[lane],
                    "name": "thread_name", "args": {"name": lname}})
    for rec in tracer.events:
        cat, name, t0, dur, lane, args = rec[:6]
        cpu = rec[6] if len(rec) > 6 else None
        tid = tid_of[lane]
        ev = {"name": name, "cat": cat, "pid": pid, "tid": tid,
              "ts": round(t0 * 1e6, 3)}
        if dur is None:
            ev["ph"] = "i"
            ev["s"] = "t"
        else:
            ev["ph"] = "X"
            ev["dur"] = round(dur * 1e6, 3)
        if cpu is not None:
            args = dict(args or (), cpu=round(cpu, 6))
        if args:
            ev["args"] = args
        out.append(ev)
    return out


def _lane_tids(tracer):
    """Stable small tids: Perfetto sorts tracks by tid, so lanes number in
    first-seen order instead of leaking thread idents."""
    tid_of = {}
    for lane in tracer.lane_names:
        tid_of.setdefault(lane, len(tid_of) + 1)
    for rec in tracer.events:
        tid_of.setdefault(rec[4], len(tid_of) + 1)
    return tid_of


def _lane_thread_ids(tracer):
    """``({tid: OS thread id}, {tid: thread ident})`` for the lanes
    :func:`chrome_events` numbers, keyed as JSON keys are, so that a
    profiler's host-side events join the lane of the thread that made
    them: a profiler with CPU activity stamps the OS thread id, a
    CUDA-only one the low 32 bits of the thread ident (the pthread id)
    on its runtime events."""
    native, ident = {}, {}
    for lane, tid in _lane_tids(tracer).items():
        if lane in tracer.lane_threads:
            native[str(tid)], ident[str(tid)] = tracer.lane_threads[lane]
    return native, ident


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
    native, ident = _lane_thread_ids(tracer)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run": tracer.run,
            "wall_start": tracer.wall_start,
            "wall_start_err_us": round(tracer.wall_start_err_us, 3),
            "lane_native_tid": native,
            "lane_thread_ident": ident,
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


def load_series(trace_path):
    """The counter events (``"ph":"C"``) of a persisted trace.json or
    crashdump.json, read back as ``{series: [(ts_seconds, value)]}``,
    each series in time order: the inverse of :func:`counter_events`,
    for the stats CLI's ``--series``."""
    with open(trace_path) as f:
        doc = json.load(f)
    series = {}
    for ev in doc.get("traceEvents", ()):
        if ev.get("ph") != "C":
            continue
        v = (ev.get("args") or {}).get("value")
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        series.setdefault(ev.get("name", "?"), []).append(
            (float(ev.get("ts", 0)) / 1e6, v))
    for s in series.values():
        s.sort(key=lambda tv: tv[0])
    return series


_SPARK = "\u2581\u2582\u2583\u2584\u2585\u2586\u2587\u2588"


def _sparkline(values, width=24):
    if not values:
        return ""
    if len(values) > width:
        # strided downsample keeping the first and the last
        idx = [i * (len(values) - 1) // (width - 1) for i in range(width)]
        values = [values[i] for i in idx]
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK[0] * len(values)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in values)


def format_series(series):
    """The ``--series`` table: per series its sample count, min, mean,
    max and last value, and a sparkline of its history."""
    if not series:
        return ("no counter samples in this trace (metrics plane off — "
                "enable with settings.metrics_interval_ms / "
                "DAMPR_TPU_TORCH_METRICS_MS)")
    lines = []
    name_w = max(len(n) for n in series)
    lines.append("{:<{w}} {:>7} {:>12} {:>12} {:>12} {:>12}  {}".format(
        "series", "samples", "min", "mean", "max", "last", "history",
        w=name_w))
    for name in sorted(series):
        vals = [v for _t, v in series[name]]
        lines.append(
            "{:<{w}} {:>7} {:>12.6g} {:>12.6g} {:>12.6g} {:>12.6g}  {}"
            .format(name, len(vals), min(vals), sum(vals) / len(vals),
                    max(vals), vals[-1], _sparkline(vals), w=name_w))
    return "\n".join(lines)


def format_pipeline_series(summary):
    """The streamed-edge view of ``--series``: per stage the queue depth
    over time (``stats()["pipeline"]["queue_depth_series"]``), the
    pipeline's overlap and stall line, and the overlap executor's
    windows.  "" when the run streamed nothing."""
    pipe = summary.get("pipeline") or {}
    series = pipe.get("queue_depth_series") or []
    lines = []
    if series:
        by_sid = {}
        for sid, _t, nbytes in series:
            by_sid.setdefault(sid, []).append(nbytes)
        lines.append("streamed-edge queue depth (bytes):")
        for sid in sorted(by_sid):
            vals = by_sid[sid]
            lines.append(
                "  stage {:<3} {:>9} peak {:>9} last  {}".format(
                    sid, _mb(max(vals)), _mb(vals[-1]),
                    _sparkline(vals)))
    if pipe.get("executed") or pipe.get("degraded"):
        lines.append(
            "pipeline: executed={} degraded={} overlap={:.2f}s "
            "({:.0%} of fold) stall={:.2f}s queue_peak={}".format(
                pipe.get("executed", 0), pipe.get("degraded", 0),
                pipe.get("overlap_seconds", 0.0),
                pipe.get("overlap_fraction", 0.0),
                pipe.get("stall_seconds", 0.0),
                _mb(pipe.get("queue_peak_bytes", 0))))
    ov = summary.get("overlap") or {}
    if ov.get("windows"):
        lines.append(
            "overlap: windows={} stall_fraction={:.3f}".format(
                ov.get("windows", 0), ov.get("stall_fraction", 0.0)))
    return "\n".join(lines)


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
    ru = summary.get("reuse")
    if ru:
        add("reuse: {} hit(s) / {} miss(es) · {} stage(s) skipped · "
            "mounted {} · published {}".format(
                ru.get("hits", 0), ru.get("misses", 0),
                ru.get("stages_skipped", 0),
                _mb(ru.get("bytes_mounted", 0)),
                _mb(ru.get("bytes_published", 0))))
        extras = []
        if ru.get("incremental_merges"):
            extras.append("{} incremental merge(s)".format(
                ru["incremental_merges"]))
        if ru.get("recompute_fallbacks"):
            extras.append("{} recompute fallback(s)".format(
                ru["recompute_fallbacks"]))
        if ru.get("evictions"):
            extras.append("{} eviction(s)".format(ru["evictions"]))
        if extras:
            add("  " + " · ".join(extras))
        interesting = [d for d in ru.get("decisions") or ()
                       if d.get("decision") not in ("miss",)]
        if interesting:
            add("  decisions: " + ", ".join(
                "s{}={}".format(d.get("stage"), d.get("decision"))
                for d in interesting))
        if ru.get("cache_dir"):
            add("  cache: {}".format(ru["cache_dir"]))
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
