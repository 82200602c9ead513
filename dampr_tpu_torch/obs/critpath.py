"""Critical-path analysis: which resource bounds each stage's wall time.

The span timeline (:mod:`.trace`) records *what happened when* on every
engine lane — codec windows, folds, spill writes and queue latency,
writer backpressure, merge generations, device program dispatches, HBM
transfers, consumer stalls.  This module walks that span DAG and answers
the diagnosis question the raw timeline leaves open: **per stage (and
for the whole run), what was the run actually waiting on?**

Method: every executed stage records one ``stage`` span on the
``stages`` lane, giving a wall window per sid.  Within each window the
resource spans are clipped and merged per resource with the same
wall-clock interval-union discipline as the live ``codec_wait`` bucket
(:func:`dampr_tpu_torch.ops.devtime.union_seconds`): two codec producer
threads tokenizing concurrently cover the wall once, not twice — so
every resource fraction is comparable against elapsed wall.  The
dominant resource is the stage's *verdict*; wall not covered by any
resource span is ``host-compute`` (generic Python/UDF time — the
fallback verdict when nothing instrumented dominates).

The bottleneck taxonomy (the JAX package's verdicts):

===============  ============================================================
verdict          meaning
===============  ============================================================
``codec``        native decode/tokenize/parse work bounds the stage
``fold``         map-side segment folds bound it
``spill-queue``  spill writes queued behind the writer pool (backpressure
                 included) — the stage outran ``spill_write_threads``
``spill-write``  spill disk writes themselves (bandwidth, not backlog)
``io-read``      frame reads outran the prefetcher
``merge``        k-way merge generations bound it
``device``       device programs (dispatch and drain) bound it
``transfer``     h2d/d2h movement (HBM tier puts/fetches)
``overlap-stall``  every live fold consumer blocked on its codec producer
``mesh``         collective folds/exchanges bound it
``host-compute`` uninstrumented host work (opaque UDFs, Python glue)
===============  ============================================================

Consumed as ``stats()["critpath"]`` (built by the runner for traced
runs).  ``skew`` (the ranks' collective-entry spread) comes from the
merged fleet timeline of a multi-process run (:func:`apply_skew`).
"""

import json
import os
import re

from ..ops.devtime import union_seconds

#: Span category -> resource (see the taxonomy table above).
_RESOURCE_BY_CAT = {
    "codec": "codec",
    "fold": "fold",
    "spill": "spill-write",
    "spill_queue": "spill-queue",
    "merge": "merge",
    "collective": "mesh",
    "exchange": "mesh",
    "hbm": "transfer",
    # Handoff spans (table-probe dispatches, the finalize that registers
    # HBM-resident refs) are device program time: the tier exists to
    # REPLACE transfer work, so classifying it as transfer would report
    # the cure as the disease.
    "handoff": "device",
    "stall": "overlap-stall",
    "checkpoint": "checkpoint",
    # Reuse-cache spans (mount hardlinking, delta re-runs, publishes)
    # are checkpoint-shaped work: durable materialization IO, never
    # productive compute — same tie-break tier as checkpoints.
    "reuse": "checkpoint",
    # Streamed-edge folder/chain spans (runner._StreamFolder) are
    # productive fold work hidden under the producing stage; the
    # publish backpressure wait rides "stall" spans named stream-wait
    # and classifies as pipeline-stall via _resource_of below.
    "pipeline": "fold",
}

#: Verdicts that may be *covered* by other work happening concurrently:
#: a stall/queue span only matters where nothing productive overlapped
#: it, so productive resources win ties at equal fractions.
_PRIORITY = ("device", "codec", "fold", "merge", "mesh", "spill-write",
             "transfer", "spill-queue", "io-read", "overlap-stall",
             "pipeline-stall", "skew", "checkpoint", "host-compute")

_STAGE_NAME = re.compile(r"^s(\d+):")


def _resource_of(cat, name):
    if cat == "io_wait":
        return "spill-queue" if "writer" in (name or "") else "io-read"
    if cat == "stall":
        # Streamed-edge publish backpressure ("stream-wait") is its own
        # verdict — the doctor's fix (raise pipeline_queue_bytes) is
        # different from the overlap executor's stall knobs, whose
        # "pipe-wait" spans stay overlap-stall.
        return ("pipeline-stall" if "stream" in (name or "")
                else "overlap-stall")
    if cat == "device":
        # Both the dispatch ("map-fold") and the drain span are device
        # time: dispatch is async, so the program's COMPUTE surfaces
        # inside the drain's block — classifying drain as transfer
        # would diagnose compute-bound runs as transfer-bound.  The
        # h2d/d2h split comes from the profiler's sub-phases (and the
        # hbm spans), not from span names.
        return "device"
    return _RESOURCE_BY_CAT.get(cat)


def normalize_events(events):
    """Accept either a live Tracer's compact tuples ``(cat, name, t0,
    dur, lane, args)`` (seconds) or persisted Chrome trace events
    (dicts, microseconds); yield ``(cat, name, t0_s, dur_s)`` for
    complete spans only."""
    out = []
    for ev in events:
        if isinstance(ev, dict):
            if ev.get("ph") != "X":
                continue
            out.append((ev.get("cat"), ev.get("name"),
                        float(ev.get("ts", 0)) / 1e6,
                        float(ev.get("dur", 0)) / 1e6))
        else:
            cat, name, t0, dur = ev[0], ev[1], ev[2], ev[3]
            if dur is None:
                continue
            out.append((cat, name, float(t0), float(dur)))
    return out


def _stage_windows(spans):
    """{sid: (t0, t1, kind)} from the per-stage spans."""
    windows = {}
    for cat, name, t0, dur in spans:
        if cat != "stage":
            continue
        m = _STAGE_NAME.match(name or "")
        if not m:
            continue
        sid = int(m.group(1))
        kind = (name or "").split(":", 1)[-1]
        windows[sid] = (t0, t0 + dur, kind)
    return windows


def _clip(intervals, lo, hi):
    for t0, t1 in intervals:
        a, b = max(t0, lo), min(t1, hi)
        if b > a:
            yield (a, b)


def _verdict_for(window, by_resource):
    """(verdict, fractions, attributed) for one wall window."""
    lo, hi = window
    wall = hi - lo
    if wall <= 1e-9:
        return "idle", {}, 0.0
    fractions = {}
    all_intervals = []
    for resource, intervals in by_resource.items():
        clipped = list(_clip(intervals, lo, hi))
        if not clipped:
            continue
        sec = union_seconds(clipped)
        if sec > 0:
            fractions[resource] = round(min(1.0, sec / wall), 4)
            all_intervals.extend(clipped)
    attributed = round(min(1.0, union_seconds(all_intervals) / wall), 4)
    unattributed = round(max(0.0, 1.0 - attributed), 4)
    if unattributed > 0:
        fractions["host-compute"] = unattributed
    verdict = max(fractions,
                  key=lambda r: (fractions[r], -_PRIORITY.index(r)
                                 if r in _PRIORITY else 0))
    return verdict, fractions, attributed


def analyze(summary, events):
    """The ``critpath`` section: per-stage and whole-run dominant-
    bottleneck verdicts from a stats summary + its span events.

    ``events`` may be live tracer tuples or persisted trace-event dicts;
    with no usable spans the section degrades to the stats-only run
    verdict (:func:`from_summary_only`)."""
    spans = normalize_events(events or ())
    if not spans:
        return from_summary_only(summary)
    by_resource = {}
    t_lo, t_hi = None, None
    for cat, name, t0, dur in spans:
        t1 = t0 + dur
        t_lo = t0 if t_lo is None else min(t_lo, t0)
        t_hi = t1 if t_hi is None else max(t_hi, t1)
        resource = _resource_of(cat, name)
        if resource is not None:
            by_resource.setdefault(resource, []).append((t0, t1))

    stages = []
    for sid, (t0, t1, kind) in sorted(_stage_windows(spans).items()):
        verdict, fractions, attributed = _verdict_for((t0, t1), by_resource)
        stages.append({
            "stage": sid, "kind": kind,
            "seconds": round(t1 - t0, 4),
            "verdict": verdict,
            "fractions": fractions,
            "attributed_fraction": attributed,
        })

    wall = summary.get("wall_seconds") or (
        (t_hi - t_lo) if t_hi is not None else 0.0)
    run_window = (0.0, max(wall, t_hi or 0.0))
    run_verdict, run_fractions, run_attr = _verdict_for(run_window,
                                                        by_resource)
    return {
        "source": "spans",
        "stages": stages,
        "run": {
            "verdict": run_verdict,
            "fractions": run_fractions,
            "attributed_fraction": run_attr,
            "seconds": round(run_window[1] - run_window[0], 4),
        },
    }


def from_summary_only(summary):
    """Degraded analysis for an untraced run: run-level fractions
    derived from the summary's own accounting (devtime buckets, io wait
    fractions, device_fraction) — no per-stage windows, so ``stages``
    carries coarse share-of-wall entries only."""
    wall = summary.get("wall_seconds") or 0.0
    fractions = {}
    if wall > 0:
        dev = summary.get("devtime") or {}
        io = summary.get("io") or {}
        device = summary.get("device") or {}
        # codec_wait is already a wall-clock union (the live bucket);
        # device_fraction is thread-seconds over wall, so clamp.
        pairs = (
            ("overlap-stall", (dev.get("codec_wait") or 0.0) / wall),
            ("spill-queue", io.get("io_wait_write_fraction") or 0.0),
            ("io-read", max(0.0, (io.get("io_wait_fraction") or 0.0)
                            - (io.get("io_wait_write_fraction") or 0.0))),
            ("device", device.get("device_fraction") or 0.0),
        )
        for resource, frac in pairs:
            if frac > 0:
                fractions[resource] = round(min(1.0, frac), 4)
    attributed = round(min(1.0, sum(fractions.values())), 4)
    fractions["host-compute"] = round(max(0.0, 1.0 - attributed), 4)
    verdict = max(fractions, key=fractions.get) if fractions else "idle"
    stages = []
    for st in summary.get("stages") or ():
        stages.append({
            "stage": st.get("stage"), "kind": st.get("kind"),
            "seconds": st.get("seconds"),
            "verdict": ("device" if st.get("target") == "device"
                        else "host-compute"),
            "fractions": {},
            "attributed_fraction": 0.0,
        })
    return {
        "source": "summary",
        "stages": stages,
        "run": {"verdict": verdict, "fractions": fractions,
                "attributed_fraction": attributed,
                "seconds": round(wall, 4)},
    }


def apply_skew(section, fleet, wall):
    """Put the fleet's ``skew`` resource into a run-level critpath
    section (in place) once the merged timeline exists.  One rank's span
    union cannot see skew (a rank waiting in a collective for a
    straggler shows as ``mesh`` time); the fleet merge
    (:func:`.fleet.step_skew`) measures the spread of the ranks' entries,
    so it becomes its own fraction (the steps' spreads over the run's
    wall, clamped) and takes the run's verdict where it dominates.  Stage
    verdicts stay as they were."""
    skew = (fleet or {}).get("skew") or {}
    sec = (skew.get("skew_seconds") or 0.0)
    run = (section or {}).get("run")
    if not run or sec <= 0 or wall <= 0:
        return section
    fractions = run.setdefault("fractions", {})
    fractions["skew"] = round(min(1.0, sec / wall), 4)
    verdict = max(fractions,
                  key=lambda r: (fractions[r], -_PRIORITY.index(r)
                                 if r in _PRIORITY else 0))
    run["verdict"] = verdict
    run["skew_seconds"] = round(sec, 4)
    return section


def from_run(run):
    """A run name, run directory or stats path resolved to (critpath
    section, summary): the summary's own section, else one recomputed
    from the persisted trace.json beside it.  (None, None) when no stats
    exist."""
    from . import export

    summary, path = export.load_stats(run)
    if summary is None:
        return None, None
    section = summary.get("critpath")
    if section:
        return section, summary
    events = ()
    tf = summary.get("trace_file")
    if not tf or not os.path.isfile(tf):
        cand = os.path.join(os.path.dirname(path), "trace.json")
        tf = cand if os.path.isfile(cand) else None
    if tf:
        try:
            with open(tf) as f:
                events = json.load(f).get("traceEvents") or ()
        except (OSError, ValueError):
            events = ()
    return analyze(summary, events), summary
