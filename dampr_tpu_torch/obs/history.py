"""Run-history corpus: one compact record per finalized run.

Port of ``dampr_tpu/obs/history.py`` (the record schema, the append and
compaction discipline, the tolerant reader, shape matching, the median
synthesis, ``vacuum`` and the corpus CLI, ``python -m
dampr_tpu_torch.cli history``).  Every finalized, named run appends one
line to a bounded JSONL index beside its scratch outputs::

    <settings.scratch_root>/<run>/history.jsonl    # history_entries cap

Each line is one self-contained record in the JAX package's schema
(``dampr-tpu-history/<version>``), so a port record loads in
``dampr_tpu.obs.history.load``: the plan fingerprint and stage shapes
(the match key), per-stage IO, critical-path verdicts and the per-op
profile when those were on, run throughput, the handoff evidence and a
snapshot of the settings that shape performance.

Durability: one ``O_APPEND`` write of one line per run (a run that dies
mid-write corrupts at most its own line); unparsable or wrong-schema
lines are skipped on read, never fatal; past ``settings.history_entries``
the file is compacted to the newest entries through tmp + atomic rename.

Consumers: :mod:`..plan.cost` (the newest matching record, or per-stage
medians over three or more, within ``settings.history_window``) and the
learned cost model :mod:`..plan.model`.
"""

import hashlib
import importlib
import json
import logging
import os
import statistics
import threading

from .. import settings

log = logging.getLogger("dampr_tpu_torch.obs.history")

#: The JAX package's record schema: readers accept every
#: ``dampr-tpu-history/<=N`` line and upgrade it in memory (:func:`upgrade`).
SCHEMA_PREFIX = "dampr-tpu-history/"
SCHEMA_VERSION = 3
SCHEMA = SCHEMA_PREFIX + str(SCHEMA_VERSION)
FILE = "history.jsonl"

_append_lock = threading.Lock()

#: Settings whose values shape run performance, snapshotted per record
#: (the JAX package's list: a knob the port does not have records None).
_KNOBS = ("analyze", "partitions", "batch_size", "max_memory_per_stage",
          "overlap_windows", "spill_write_threads", "spill_read_prefetch",
          "merge_fanin", "max_processes", "optimize", "profile",
          "mesh_exchange", "exchange_hbm_budget", "exchange_chunk_bytes",
          "exchange_min_bytes", "job_retries", "io_retries",
          "retry_backoff_ms", "max_quarantined", "exchange_timeout_ms",
          "mitigate", "speculate_threshold", "speculate_after_steps",
          "mitigate_probe_windows", "exchange_coding", "cost_model",
          "autotune", "autotune_trials", "handoff", "reuse",
          "reuse_budget_bytes", "pipeline", "pipeline_queue_bytes",
          "exchange_codec")

#: Knobs the port keeps as module constants rather than settings:
#: knob -> (module of this package, attribute).
_CONSTANT_KNOBS = {
    "overlap_windows": ("runner", "OVERLAP_WINDOWS"),
    "spill_read_prefetch": ("storage", "SPILL_READ_PREFETCH"),
    "spill_codec": ("storage", "SPILL_CODEC"),
}


def knob_home(knob):
    """(object, attribute) holding a performance knob in this process:
    the settings module, or the module the port keeps it in as a
    constant; None when the port has no such knob."""
    where = _CONSTANT_KNOBS.get(knob)
    if where is not None:
        mod = importlib.import_module(
            "{}.{}".format(__package__.rsplit(".", 1)[0], where[0]))
        return mod, where[1]
    if hasattr(settings, knob):
        return settings, knob
    return None


def knob_value(knob):
    """This process's value of a performance knob, or None when the port
    has no such knob."""
    home = knob_home(knob)
    return getattr(*home) if home is not None else None


def schema_version(rec):
    """The integer schema version of a record, or None when the schema
    tag is missing, foreign or newer than this reader understands."""
    tag = (rec or {}).get("schema")
    if not isinstance(tag, str) or not tag.startswith(SCHEMA_PREFIX):
        return None
    try:
        v = int(tag[len(SCHEMA_PREFIX):])
    except ValueError:
        return None
    return v if 1 <= v <= SCHEMA_VERSION else None


def upgrade(rec):
    """In-memory upgrade of an older record to the current feature
    surface (v1: per-stage ``shuffle_target`` None, empty ``settings`` and
    ``throughput``; v2: an empty ``health`` block), stamping ``v``.  The
    line on disk is never rewritten here."""
    v = schema_version(rec) or 1
    rec["v"] = v
    if v < 2:
        for st in rec.get("stages") or ():
            if isinstance(st, dict):
                st.setdefault("shuffle_target", None)
        rec.setdefault("settings", {})
        rec.setdefault("throughput", {})
    if v < 3:
        rec.setdefault("health", {})
    return rec


def corpus_path(run_name):
    """Where a run name's corpus lives: beside its scratch outputs under
    ``settings.scratch_root`` (never under ``trace_dir``)."""
    safe = str(run_name).replace("/", "_")
    return os.path.join(settings.scratch_root, safe, FILE)


def plan_fingerprint(stage_shapes):
    """Stable fingerprint of a plan's executed stage-shape sequence (the
    corpus match key)."""
    text = "|".join(s.get("shape", "?") for s in stage_shapes or ())
    return hashlib.sha1(text.encode("utf-8")).hexdigest()[:16]


def _settings_snapshot():
    snap = {k: knob_value(k) for k in _KNOBS}
    snap["lower"] = str(settings.lower)
    snap["metrics_interval_ms"] = settings.metrics_interval_ms
    snap["spill_codec"] = str(knob_value("spill_codec"))
    return snap


def _health_section(summary):
    """The v3 run-health scalars: only keys with a real sample land."""
    out = {}
    faults = summary.get("faults") or {}
    if "retries" in faults:
        out["retries"] = faults.get("retries")
    if "quarantined" in faults:
        q = faults.get("quarantined")
        out["quarantined"] = len(q) if isinstance(q, (list, dict)) else q
    skew = (summary.get("fleet") or {}).get("skew") or {}
    mit = summary.get("mitigation") or {}
    late = skew.get("late_ratio")
    if late is None:
        late = mit.get("last_late_ratio")
    if late is not None:
        out["late_ratio"] = late
    reuse = summary.get("reuse") or {}
    hits, misses = reuse.get("hits"), reuse.get("misses")
    if isinstance(hits, int) and isinstance(misses, int) \
            and hits + misses > 0:
        out["reuse_hit_rate"] = round(hits / float(hits + misses), 4)
    return out


def compact_record(summary):
    """One corpus line from a finalized run summary (the stats.json
    dict): per-stage scalars, verdict strings and the top per-op timings,
    never spans or series."""
    stages = []
    for st in summary.get("stages") or ():
        stages.append({k: st.get(k) for k in (
            "stage", "kind", "target", "shuffle_target", "jobs",
            "records_in", "records_out", "bytes_in", "bytes_out",
            "spill_bytes", "seconds")})
    totals = summary.get("totals") or {}
    device = summary.get("device") or {}
    rec = {
        "schema": SCHEMA,
        "v": SCHEMA_VERSION,
        "run": summary.get("run"),
        "ts": summary.get("started_at"),
        "wall_seconds": summary.get("wall_seconds"),
        "n_partitions": summary.get("n_partitions"),
        "stage_shapes": (summary.get("plan") or {}).get("stage_shapes") or [],
        "stages": stages,
        "throughput": {
            "records_out": totals.get("records_out"),
            "bytes_out": totals.get("bytes_out"),
            "mbps": (round(totals.get("bytes_out", 0) / 1e6
                           / summary["wall_seconds"], 3)
                     if summary.get("wall_seconds") else None),
        },
        "device_fraction": device.get("device_fraction"),
        # the handoff evidence model.price_handoff prices across runs
        "handoff": {
            "edges": device.get("handoff_edges", 0),
            "bytes": device.get("handoff_bytes", 0),
            "d2h_avoided_bytes": device.get("d2h_avoided_bytes", 0),
            "degrades": device.get("handoff_degrades", 0),
        },
        "io_wait_fraction": (summary.get("io") or {}).get(
            "io_wait_fraction"),
        "health": _health_section(summary),
        "settings": _settings_snapshot(),
    }
    proc = summary.get("process") or {}
    if proc:
        rec["process"] = {"process_id": proc.get("process_id", 0),
                          "num_processes": proc.get("num_processes", 1)}
    # a non-zero rank's record is tagged, and matching() leaves it out
    if proc.get("process_id"):
        rec["rank"] = proc["process_id"]
    rec["fingerprint"] = plan_fingerprint(rec["stage_shapes"])
    crit = summary.get("critpath")
    if crit:
        rec["critpath"] = {
            "run": (crit.get("run") or {}).get("verdict"),
            "stages": {str(s.get("stage")): s.get("verdict")
                       for s in crit.get("stages") or ()},
        }
    prof = summary.get("profile")
    if prof:
        rec["profile"] = {
            str(s["stage"]): [[o["op"], o["seconds"], o["records"]]
                              for o in (s.get("ops") or [])[:5]]
            for s in prof.get("stages") or ()
        }
    return rec


def append(summary):
    """Append one finalized run's record; best-effort (a corpus failure
    never fails a run) and bounded.  Returns the corpus path or None."""
    if settings.history_entries <= 0:
        return None
    run = summary.get("run")
    if not run or not summary.get("stages"):
        return None
    try:
        line = json.dumps(compact_record(summary), sort_keys=True,
                          separators=(",", ":"), default=str)
        if "\n" in line:  # a repr leaked a newline: never corrupt the
            return None   # line-oriented index
        path = corpus_path(run)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with _append_lock:
            fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT,
                         0o644)
            try:
                os.write(fd, (line + "\n").encode("utf-8"))
            finally:
                os.close(fd)
            _compact_if_over(path)
        return path
    except Exception:
        log.debug("history corpus append failed for %r", run,
                  exc_info=True)
        return None


def _compact_if_over(path):
    """Rewrite the corpus keeping only the newest ``history_entries``
    valid lines (tmp + atomic replace; called under the append lock)."""
    cap = settings.history_entries
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return
    if len(lines) <= cap:
        return
    keep = [ln for ln in lines if _valid_line(ln) is not None][-cap:]
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.writelines(keep)
    os.replace(tmp, path)


def _valid_line(line):
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        return None
    if not isinstance(rec, dict) or schema_version(rec) is None:
        return None
    if not isinstance(rec.get("stages"), list):
        return None
    return upgrade(rec)


def load(run_name):
    """Every valid record for a run name, oldest first.  Never raises: a
    missing or corrupt corpus is an empty history."""
    path = corpus_path(run_name) if run_name else None
    if not path or not os.path.isfile(path):
        return []
    out = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                rec = _valid_line(line)
                if rec is not None:
                    out.append(rec)
    except OSError:
        return []
    return out


def matching(records, stage_shapes):
    """Records whose stage-shape sequence equals ``stage_shapes`` (per-sid
    measurements mean nothing across plan shapes), rank-tagged records
    left out."""
    want = [s.get("shape") for s in stage_shapes or ()]
    return [r for r in records
            if not r.get("rank")
            and [s.get("shape")
                 for s in r.get("stage_shapes") or ()] == want]


def _median(values):
    vals = [v for v in values if isinstance(v, (int, float))
            and not isinstance(v, bool)]
    if not vals:
        return None
    m = statistics.median(vals)
    return int(m) if all(isinstance(v, int) for v in vals) else m


def synthesize(records):
    """Fold shape-matching records into one summary-shaped history dict:
    the newest record's stages verbatim for one or two records, per-stage
    medians of the IO measurements for three or more (one outlier run
    stops steering the sizing)."""
    if not records:
        return None
    newest = records[-1]
    n = len(records)
    if n < 3:
        stages = [dict(st) for st in newest.get("stages") or ()]
    else:
        by_sid = {}
        for rec in records:
            for st in rec.get("stages") or ():
                by_sid.setdefault(st.get("stage"), []).append(st)
        stages = []
        for _sid, sts in sorted(by_sid.items()):
            med = dict(sts[-1])  # kind/target/stage from the newest
            for field in ("jobs", "records_in", "records_out", "bytes_in",
                          "bytes_out", "spill_bytes", "seconds"):
                v = _median([st.get(field) for st in sts])
                if v is not None:
                    med[field] = v
            stages.append(med)
    return {
        "run": newest.get("run"),
        "stages": stages,
        "plan": {"stage_shapes": newest.get("stage_shapes") or []},
        "stats_file": "history:{}#n={}".format(
            corpus_path(newest.get("run")), n),
        "history_entries": n,
    }


def vacuum(path, cap=None):
    """Rewrite one corpus in place: drop invalid lines, rewrite every
    survivor at the current schema, keep the newest ``cap``
    (``settings.history_entries`` by default).  Returns (kept, dropped)."""
    cap = settings.history_entries if cap is None else cap
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return (0, 0)
    recs = [r for r in (_valid_line(ln) for ln in lines) if r is not None]
    if cap > 0:
        recs = recs[-cap:]
    for rec in recs:
        rec["schema"] = SCHEMA
        rec["v"] = SCHEMA_VERSION
    tmp = path + ".tmp"
    with _append_lock:
        with open(tmp, "w", encoding="utf-8") as f:
            for rec in recs:
                f.write(json.dumps(rec, sort_keys=True,
                                   separators=(",", ":"), default=str))
                f.write("\n")
        os.replace(tmp, path)
    return (len(recs), len(lines) - len(recs))


# -- the corpus CLI (``python -m dampr_tpu_torch.cli history``) -------------

def _iter_corpora():
    """Every (run name, corpus path) under the scratch root."""
    root = settings.scratch_root
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return
    for name in names:
        path = os.path.join(root, name, FILE)
        if os.path.isfile(path):
            yield name, path


def _fmt_record(rec):
    tp = rec.get("throughput") or {}
    return "  {ts:<20} v{v} fp={fp} wall={wall} mbps={mbps}{rank}".format(
        ts=str(rec.get("ts", "?"))[:20], v=rec.get("v", "?"),
        fp=rec.get("fingerprint", "?"),
        wall=("{:.2f}s".format(rec["wall_seconds"])
              if isinstance(rec.get("wall_seconds"), (int, float))
              else "?"),
        mbps=tp.get("mbps", "?"),
        rank=(" rank={}".format(rec["rank"]) if rec.get("rank") else ""))


def main(argv=None):
    """Inspect and maintain run-history corpora.

    With no run name, lists every corpus under the scratch root; with
    one, lists its records (newest last), ``--fingerprint`` keeping one
    plan shape.  ``--gc`` compacts to the retention cap; ``--vacuum``
    also drops invalid lines and rewrites old-schema records at the
    current version.  Exit 1 when the named run has no corpus.
    """
    import argparse

    p = argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli history",
        description="inspect / maintain dampr_tpu_torch run-history "
                    "corpora")
    p.add_argument("run", nargs="?", help="run name (default: list all)")
    p.add_argument("--list", action="store_true",
                   help="list corpora under the scratch root")
    p.add_argument("--fingerprint", metavar="F",
                   help="only records with this plan fingerprint")
    p.add_argument("--gc", action="store_true",
                   help="compact to the newest history_entries records")
    p.add_argument("--vacuum", action="store_true",
                   help="gc + drop invalid lines + upgrade old records "
                        "on disk")
    p.add_argument("--json", action="store_true", help="machine output")
    args = p.parse_args(argv)

    if args.run:
        targets = [(args.run, corpus_path(args.run))]
        if not os.path.isfile(targets[0][1]):
            print("no history corpus for run {!r} under {}".format(
                args.run, settings.scratch_root))
            return 1
    else:
        targets = list(_iter_corpora())

    if args.vacuum or args.gc:
        report = []
        for name, path in targets:
            if args.vacuum:
                kept, dropped = vacuum(path)
            else:
                with _append_lock:
                    _compact_if_over(path)
                with open(path, encoding="utf-8", errors="replace") as f:
                    kept = sum(1 for ln in f if _valid_line(ln) is not None)
                dropped = 0
            report.append({"run": name, "path": path,
                           "kept": kept, "dropped": dropped})
        if args.json:
            print(json.dumps(report, indent=2, sort_keys=True))
        else:
            for r in report:
                print("{run}: kept {kept} record(s), dropped {dropped} "
                      "({path})".format(**r))
        return 0

    if args.run:
        recs = load(args.run)
        if args.fingerprint:
            recs = [r for r in recs
                    if r.get("fingerprint") == args.fingerprint]
        if args.json:
            print(json.dumps(recs, indent=2, sort_keys=True, default=str))
        else:
            print("{} — {} record(s)".format(args.run, len(recs)))
            for rec in recs:
                print(_fmt_record(rec))
        return 0

    rows = []
    for name, path in targets:
        recs = load(name)
        fps = sorted({r.get("fingerprint") for r in recs
                      if r.get("fingerprint")})
        rows.append({"run": name, "records": len(recs),
                     "fingerprints": fps,
                     "newest": recs[-1].get("ts") if recs else None,
                     "path": path})
    if args.json:
        print(json.dumps(rows, indent=2, sort_keys=True, default=str))
    else:
        if not rows:
            print("no history corpora under {}".format(
                settings.scratch_root))
        for r in rows:
            print("{run:<24} {records:>4} record(s)  {nfp} plan shape(s)"
                  "  newest={newest}".format(
                      nfp=len(r["fingerprints"]), **r))
    return 0


if __name__ == "__main__":
    import sys as _sys

    _sys.exit(main())
