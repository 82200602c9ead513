"""Fleet observability: the ranks' telemetry merged into one timeline.

Port of ``dampr_tpu/obs/fleet.py``, whole.  Every rank of a traced
multi-process run writes its own artifacts (rank 0 under ``<run>/trace/``,
rank k under ``<run>/trace/rank<k>/``: :func:`.export.run_trace_dir`);
this module reads them back and answers which rank is the straggler, and
why:

- :func:`merge_traces` folds the ranks' ``trace.json`` files into one
  Perfetto timeline, a process lane per rank (Chrome ``pid`` = rank + 1,
  named ``rank<k>``), counter series renamed ``rank<k>/<series>``.
- **Clock alignment** trusts no wall clock: at
  :func:`..parallel.mesh.init_distributed` every rank leaves one barrier
  and records its monotonic clock there
  (:data:`..parallel.mesh.clock_sync`), so shifting each rank's events by
  ``epoch_perf - barrier_perf`` puts them on one axis.  A run without the
  handshake aligns on wall starts and says so (``alignment: "wall"``).
- :func:`fleet_section` builds ``stats()["fleet"]``: per-rank totals,
  the rank x rank exchange matrices (from the exchange's per-device
  routes) and the per-step **skew**: for each exchange step, the spread
  of the ranks' entries as a share of the step's wall, which tells "the
  network is slow" (low skew) from "rank 2 is late" (high skew).

Rank 0 merges at finalize (waiting at most ``settings.fleet_wait_ms`` for
its siblings, so a dead one cannot wedge it); ``python -m
dampr_tpu_torch.cli stats --fleet`` merges afterwards.  The merged
timeline is ``<run>/trace/fleet/trace.json`` and validates against
``docs/trace_schema.json``.
"""

import json
import logging
import os
import re
import time

log = logging.getLogger("dampr_tpu_torch.obs.fleet")

MERGED_TRACE_FILE = "trace.json"
FLEET_DIR = "fleet"

_RANK_DIR = re.compile(r"^rank(\d+)$")
_STEP_NAME = re.compile(r"^step:(\d+)$")


def resolve_base_dir(run_or_dir):
    """The run's rank-0 (legacy) trace directory for a run name, a run
    scratch directory, or a trace directory / artifact path."""
    from . import export as _export

    p = str(run_or_dir)
    if os.path.isfile(p):
        p = os.path.dirname(os.path.abspath(p))
    if os.path.isdir(p):
        if os.path.isdir(os.path.join(p, "trace")):
            return os.path.join(p, "trace")
        return p
    return _export.run_trace_dir(p, rank=0)


def rank_dirs(run_or_dir):
    """{rank: per-rank trace dir} discovered on disk.  Rank 0 is the
    base dir itself (legacy layout); non-zero ranks are ``rank<k>/``
    subdirectories."""
    base = resolve_base_dir(run_or_dir)
    out = {}
    if os.path.isdir(base):
        out[0] = base
        for entry in sorted(os.listdir(base)):
            m = _RANK_DIR.match(entry)
            if m and os.path.isdir(os.path.join(base, entry)):
                out[int(m.group(1))] = os.path.join(base, entry)
    return out


def _load_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def load_ranks(run_or_dir):
    """{rank: {"dir", "trace" (doc or None), "stats" (dict or None)}}
    for every per-rank directory that holds at least one artifact."""
    from . import export as _export

    out = {}
    for rank, d in rank_dirs(run_or_dir).items():
        trace = _load_json(os.path.join(d, _export.TRACE_FILE))
        stats = _load_json(os.path.join(d, _export.STATS_FILE))
        if trace is None and stats is None:
            continue
        out[rank] = {"dir": d, "trace": trace, "stats": stats}
    return out


# -- clock alignment ---------------------------------------------------------

def _proc_block(rank_data):
    doc = rank_data.get("trace") or {}
    proc = (doc.get("otherData") or {}).get("process")
    if proc:
        return proc
    return (rank_data.get("stats") or {}).get("process") or {}


def clock_shifts(ranks):
    """Per-rank timeline shift (seconds added to a rank's relative event
    timestamps to land on the fleet-common axis) and the alignment mode.

    Clock mode (every rank carries the barrier handshake): common zero
    is the barrier instant — ``shift = epoch_perf - barrier_perf`` (the
    tracer epoch's signed distance past the barrier on that rank's own
    monotonic clock).  Wall mode (any rank missing the handshake):
    shifts derive from ``wall_start`` deltas against the earliest rank —
    honest but NTP-trusting, flagged so consumers can tell.  A final
    normalization makes the earliest shifted event sit at t=0 either
    way."""
    anchors = {}
    walls = {}
    clock_ok = True
    for rank, data in ranks.items():
        proc = _proc_block(data)
        clock = proc.get("clock") or {}
        epoch = proc.get("epoch_perf")
        if epoch is not None and clock.get("barrier_perf") is not None:
            anchors[rank] = float(epoch) - float(clock["barrier_perf"])
        else:
            clock_ok = False
        doc = data.get("trace") or {}
        ws = (doc.get("otherData") or {}).get("wall_start")
        if ws is None:
            ws = (data.get("stats") or {}).get("started_at")
        walls[rank] = float(ws) if ws is not None else 0.0
    if clock_ok and len(anchors) == len(ranks) and ranks:
        return dict(anchors), "clock"
    if len(ranks) <= 1:
        return {rank: 0.0 for rank in ranks}, "none"
    w0 = min(walls.values()) if walls else 0.0
    return {rank: walls.get(rank, 0.0) - w0 for rank in ranks}, "wall"


def _events_of(rank_data):
    doc = rank_data.get("trace") or {}
    return doc.get("traceEvents") or []


# -- merge -------------------------------------------------------------------

def merge_traces(ranks, shifts, run_name=None):
    """Fold per-rank Chrome trace docs into one multi-process document.

    Per rank: ``pid`` = rank + 1 with a ``process_name`` metadata lane
    (``rank<k>``), thread lanes carried through per-pid, X/i/C event
    timestamps shifted onto the common axis, and counter series renamed
    ``rank<k>/<series>`` (distinct Perfetto counter tracks; keeps the
    validator's per-series monotonic pin).  Timestamps are re-based so
    the earliest merged event sits at ts=0 (Perfetto-friendly, and the
    schema's counter clamp stays valid)."""
    # Pass 1: earliest shifted timestamp across the fleet.
    t_min = None
    for rank, data in ranks.items():
        us = shifts.get(rank, 0.0) * 1e6
        for ev in _events_of(data):
            ts = ev.get("ts")
            if isinstance(ts, (int, float)):
                t = ts + us
                t_min = t if t_min is None else min(t_min, t)
    t_min = t_min or 0.0

    events = []
    wall_start = None
    for rank in sorted(ranks):
        data = ranks[rank]
        pid = rank + 1
        us = shifts.get(rank, 0.0) * 1e6
        doc = data.get("trace") or {}
        ws = (doc.get("otherData") or {}).get("wall_start")
        if ws is not None:
            wall_start = ws if wall_start is None else min(wall_start, ws)
        n = _proc_block(data).get("num_processes")
        events.append({
            "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
            "args": {"name": "rank{}{}".format(
                rank, "/{}".format(n) if n else "")}})
        for ev in _events_of(data):
            ph = ev.get("ph")
            if ph == "M":
                if ev.get("name") == "process_name":
                    continue  # replaced by the rank lane name above
                ev = dict(ev, pid=pid)
            elif ph in ("X", "i", "C"):
                ev = dict(ev, pid=pid)
                ts = ev.get("ts")
                if isinstance(ts, (int, float)):
                    ev["ts"] = round(ts + us - t_min, 3)
                if ph == "C":
                    ev["name"] = "rank{}/{}".format(rank, ev.get("name"))
            else:
                ev = dict(ev, pid=pid)
            events.append(ev)
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "run": run_name or next(
                ((d.get("trace") or {}).get("otherData", {}).get("run")
                 or (d.get("stats") or {}).get("run")
                 for d in ranks.values()), None) or "?",
            "wall_start": wall_start or 0.0,
            "producer": "dampr_tpu_torch.obs.fleet",
        },
    }, t_min


# -- skew --------------------------------------------------------------------

def straggler_of(mean_late):
    """``(straggler_rank, late_ratio)`` from per-rank mean entry
    lateness ({rank: seconds late after the first arriver}).  The ratio
    is the straggler's lateness over the fleet mean (>= 1.0) — the
    number the doctor renders as "rank K enters steps N.Nx late" and the
    live mitigation controller (:mod:`..parallel.mitigate`)
    thresholds against ``settings.speculate_threshold``.  One shared
    definition so the post-hoc and live signals can never disagree."""
    if not mean_late:
        return None, 1.0
    straggler = max(mean_late, key=mean_late.get)
    fleet_mean = sum(mean_late.values()) / len(mean_late)
    if fleet_mean <= 1e-12:
        return straggler, 1.0
    return straggler, mean_late[straggler] / fleet_mean


def step_skew(ranks, shifts):
    """Per-collective-step skew from the aligned ``exchange`` step
    spans: for each chunked all_to_all step seen by >= 2 ranks, the
    spread between the earliest and latest rank ENTRY as a fraction of
    the step's fleet wall (first entry -> last exit).  Fractions are in
    [0, 1] by construction; per-rank mean entry lateness (seconds after
    the first arriver, averaged over steps) names the straggler."""
    entries = {}  # step id -> {rank: (entry_s, exit_s)}
    for rank, data in ranks.items():
        shift = shifts.get(rank, 0.0)
        for ev in _events_of(data):
            if ev.get("ph") != "X" or ev.get("cat") != "exchange":
                continue
            m = _STEP_NAME.match(ev.get("name") or "")
            if not m:
                continue
            t0 = float(ev.get("ts", 0.0)) / 1e6 + shift
            t1 = t0 + float(ev.get("dur", 0.0)) / 1e6
            step = int(m.group(1))
            # A rank may run several exchanges (several windows reuse
            # step ids): key by occurrence index per (rank, step) so
            # the i-th occurrence on every rank lines up.
            occ = sum(1 for r in entries.get(step, {}) if r[0] == rank)
            entries.setdefault(step, {})[(rank, occ)] = (t0, t1)
    steps = []
    lateness = {}  # rank -> [seconds late per step]
    for step in sorted(entries):
        by_occ = {}
        for (rank, occ), tt in entries[step].items():
            by_occ.setdefault(occ, {})[rank] = tt
        for occ in sorted(by_occ):
            per_rank = by_occ[occ]
            if len(per_rank) < 2:
                continue
            first = min(t0 for t0, _t1 in per_rank.values())
            last_entry = max(t0 for t0, _t1 in per_rank.values())
            last_exit = max(t1 for _t0, t1 in per_rank.values())
            wall = last_exit - first
            spread = last_entry - first
            frac = 0.0
            if wall > 1e-12:
                frac = max(0.0, min(1.0, spread / wall))
            rank_entries = {}
            for rank, (t0, _t1) in sorted(per_rank.items()):
                late = t0 - first
                rank_entries[str(rank)] = round(late, 6)
                lateness.setdefault(rank, []).append(late)
            steps.append({
                "step": step,
                "spread_seconds": round(max(0.0, spread), 6),
                "wall_seconds": round(max(0.0, wall), 6),
                "fraction": round(frac, 4),
                "entry_lateness": rank_entries,
            })
    if not steps:
        return None
    mean_late = {rank: sum(ls) / len(ls) for rank, ls in lateness.items()}
    straggler, late_ratio = straggler_of(mean_late)
    fracs = [s["fraction"] for s in steps]
    return {
        "steps": steps,
        "skew_seconds": round(sum(s["spread_seconds"] for s in steps), 6),
        "max_fraction": round(max(fracs), 4),
        "mean_fraction": round(sum(fracs) / len(fracs), 4),
        "straggler_rank": straggler,
        "mean_entry_lateness": {str(r): round(v, 6)
                                for r, v in sorted(mean_late.items())},
        # How much later the straggler enters collectives than the fleet
        # average (>= 1; the doctor's "rank K enters steps N.Nx late").
        "late_ratio": round(late_ratio, 2),
    }


# -- fleet stats section -----------------------------------------------------

def _rank_of_device(dev, num_processes, n_devices):
    if n_devices <= 0 or num_processes <= 0:
        return 0
    per = max(1, n_devices // num_processes)
    return min(num_processes - 1, int(dev) // per)


def _device_count(ranks, num_processes):
    """Global device count for the device->rank mapping.  The
    authoritative source is the process block's ``global_devices``
    (stamped once the process group is up: the global mesh orders the
    ranks' local shards contiguously, so the rank of shard d is
    d // per_proc).
    Fallback: the largest device index seen in any route (+1), which
    undercounts when high devices moved nothing — hence the preference
    order."""
    counts = []
    for data in ranks.values():
        doc = data.get("trace") or {}
        for proc in ((doc.get("otherData") or {}).get("process"),
                     (data.get("stats") or {}).get("process")):
            c = (proc or {}).get("global_devices")
            if isinstance(c, int) and c > 0:
                counts.append(c)
    if counts:
        return max(counts)
    hi = -1
    for data in ranks.values():
        ex = (((data.get("stats") or {}).get("mesh") or {})
              .get("exchange") or {})
        for s, d, _n in ex.get("routes") or ():
            hi = max(hi, int(s), int(d))
        for key in ("sent_per_device", "received_per_device"):
            for dev in (ex.get(key) or {}):
                try:
                    hi = max(hi, int(dev))
                except (TypeError, ValueError):
                    pass
    return hi + 1 if hi >= 0 else num_processes


def _exchange_matrices(ranks, num_processes, n_dev):
    """rank x rank sent-bytes matrix from the per-device route triples
    (``mesh.exchange.routes`` — identical on every rank, since each rank
    observes the global schedule; the first rank that recorded routes
    wins)."""
    for _rank, data in sorted(ranks.items()):
        ex = (((data.get("stats") or {}).get("mesh") or {})
              .get("exchange") or {})
        routes = ex.get("routes")
        if not routes:
            continue
        sent = [[0] * num_processes for _ in range(num_processes)]
        for s, d, n in routes:
            rs = _rank_of_device(s, num_processes, n_dev)
            rd = _rank_of_device(d, num_processes, n_dev)
            sent[rs][rd] += int(n)
        recv = [[sent[s][d] for s in range(num_processes)]
                for d in range(num_processes)]
        return {
            "devices": n_dev,
            "bytes": sum(int(n) for _s, _d, n in routes),
            "rank_sent_matrix": sent,
            "rank_received_matrix": recv,
        }
    return None


def fleet_section(ranks, shifts=None, alignment=None):
    """The ``stats()["fleet"]`` payload from loaded per-rank artifacts.
    Returns None for single-process runs (back-compat: the section is
    absent, never empty-but-present)."""
    if not ranks:
        return None
    num = max((_proc_block(d).get("num_processes") or 1)
              for d in ranks.values())
    num = max(num, max(ranks) + 1)
    if num <= 1:
        return None
    if shifts is None:
        shifts, alignment = clock_shifts(ranks)
    n_dev = _device_count(ranks, num)

    def _own_device_sum(per_device, rank):
        # The exchange accounting is GLOBAL on every rank (the host side
        # packs the full schedule), so per-rank traffic must be sliced
        # to the devices that rank actually owns — summing everything
        # would report the identical fleet total on every row.
        total = 0
        for dev, n in (per_device or {}).items():
            try:
                dev = int(dev)
            except (TypeError, ValueError):
                continue
            if _rank_of_device(dev, num, n_dev) == rank:
                total += n
        return total

    per_rank = []
    for rank in sorted(ranks):
        stats = ranks[rank].get("stats") or {}
        totals = stats.get("totals") or {}
        ex = ((stats.get("mesh") or {}).get("exchange") or {})
        entry = {
            "rank": rank,
            "wall_seconds": stats.get("wall_seconds"),
            "records_out": totals.get("records_out"),
            "bytes_out": totals.get("bytes_out"),
            "spill_bytes": totals.get("spill_bytes"),
            "io_wait_fraction": (stats.get("io") or {}).get(
                "io_wait_fraction"),
            "device_fraction": (stats.get("device") or {}).get(
                "device_fraction"),
            "verdict": ((stats.get("critpath") or {}).get("run")
                        or {}).get("verdict"),
            "exchange_sent_bytes": _own_device_sum(
                ex.get("sent_per_device"), rank),
            "exchange_received_bytes": _own_device_sum(
                ex.get("received_per_device"), rank),
        }
        per_rank.append(entry)
    section = {
        "num_processes": num,
        "ranks": sorted(ranks),
        "missing_ranks": [r for r in range(num) if r not in ranks],
        "alignment": alignment or "none",
        "per_rank": per_rank,
    }
    matrices = _exchange_matrices(ranks, num, n_dev)
    if matrices is not None:
        section["exchange"] = matrices
    # Mitigation visibility (parallel.mitigate): the shared
    # collective state (engagements, skipped windows, down-weights) is
    # identical on every rank by construction, but steals and
    # speculative wins are LOCAL per-rank counters — the fleet view
    # sums them so host-path mitigation on any rank is visible, next to
    # the skew that triggered it.
    mits = [(rank, (data.get("stats") or {}).get("mitigation"))
            for rank, data in sorted(ranks.items())
            if (data.get("stats") or {}).get("mitigation")]
    if mits:
        merged = dict(mits[0][1])
        for key in ("speculative_attempts", "speculative_wins",
                    "stolen_partitions"):
            merged[key] = sum(int(m.get(key) or 0) for _r, m in mits)
        section["mitigation"] = merged
    skew = step_skew(ranks, shifts)
    if skew is not None:
        section["skew"] = skew
        by_rank = {e["rank"]: e for e in per_rank}
        for rank_s, late in skew["mean_entry_lateness"].items():
            e = by_rank.get(int(rank_s))
            if e is not None:
                e["mean_entry_lateness_seconds"] = late
    return section


# -- orchestration -----------------------------------------------------------

def _expected_ranks(ranks, summary=None):
    num = 1
    if summary is not None:
        num = (summary.get("process") or {}).get("num_processes") or 1
    for data in ranks.values():
        num = max(num, _proc_block(data).get("num_processes") or 1)
    return num


def wait_for_ranks(run_or_dir, num_processes, wait_ms):
    """Poll (bounded) until every expected rank's stats.json landed.
    Returns the list of ranks still MISSING at the deadline (empty =
    everyone arrived) — a killed sibling stops arriving and the
    deadline moves the merge on with what exists."""
    from . import export as _export

    deadline = time.monotonic() + max(0, wait_ms) / 1000.0
    base = resolve_base_dir(run_or_dir)
    while True:
        missing = []
        for rank in range(num_processes):
            d = base if rank == 0 else os.path.join(
                base, "rank{}".format(rank))
            if not os.path.isfile(os.path.join(d, _export.STATS_FILE)):
                missing.append(rank)
        if not missing or time.monotonic() >= deadline:
            return missing
        time.sleep(0.05)


def merge_run(run_or_dir, wait_ms=0, summary=None, write=True):
    """Build the merged fleet timeline + ``fleet`` stats section for a
    run and (by default) persist both: the merged Perfetto trace at
    ``<base>/fleet/trace.json`` and the section injected into rank 0's
    ``stats.json``.  Returns the fleet section (None when the run was
    single-process or left no per-rank artifacts)."""
    from . import critpath as _critpath, export as _export

    ranks = load_ranks(run_or_dir)
    num = _expected_ranks(ranks, summary)
    if wait_ms and num > 1:
        missing = wait_for_ranks(run_or_dir, num, wait_ms)
        if missing:
            log.warning("fleet merge proceeding without rank(s) %s "
                        "(deadline %d ms)", missing, wait_ms)
        ranks = load_ranks(run_or_dir)
    if not ranks:
        return None
    shifts, alignment = clock_shifts(ranks)
    section = fleet_section(ranks, shifts, alignment)
    if section is None:
        return None
    merged, _t0 = merge_traces(ranks, shifts)
    base = resolve_base_dir(run_or_dir)
    if write:
        fdir = os.path.join(base, FLEET_DIR)
        os.makedirs(fdir, exist_ok=True)
        mpath = os.path.join(fdir, MERGED_TRACE_FILE)
        tmp = mpath + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f)
        os.replace(tmp, mpath)
        section["merged_trace_file"] = mpath
        # Rank 0's stats.json is the fleet's front door: re-persist it
        # with the fleet section (and a skew-aware critpath) attached.
        spath = os.path.join(base, _export.STATS_FILE)
        stats = _load_json(spath)
        if stats is not None:
            stats["fleet"] = section
            if stats.get("critpath"):
                _critpath.apply_skew(stats["critpath"], section,
                                     stats.get("wall_seconds") or 0.0)
            _export.write_stats(stats, spath)
            if summary is not None and summary.get("critpath"):
                _critpath.apply_skew(summary["critpath"], section,
                                     summary.get("wall_seconds") or 0.0)
    return section


def format_fleet(section):
    """Human rendering for ``cli stats --fleet``."""
    if not section:
        return "no fleet section: single-process run (nothing to merge)"
    lines = []
    add = lines.append
    add("fleet: {} process(es), ranks present {} · alignment: {}".format(
        section.get("num_processes"), section.get("ranks"),
        section.get("alignment")))
    if section.get("missing_ranks"):
        add("MISSING ranks: {} (killed or still running)".format(
            section["missing_ranks"]))
    add("{:>5} {:>9} {:>12} {:>10} {:>10} {:>11} {:>11}  {}".format(
        "rank", "wall", "records", "bytes", "spill", "ex_sent",
        "ex_recv", "verdict"))
    for e in section.get("per_rank") or ():
        add("{:>5} {:>9} {:>12} {:>10} {:>10} {:>11} {:>11}  {}".format(
            e.get("rank"),
            "{:.2f}s".format(e["wall_seconds"])
            if e.get("wall_seconds") is not None else "-",
            e.get("records_out") if e.get("records_out") is not None
            else "-",
            "{:.1f}MB".format((e.get("bytes_out") or 0) / 1e6),
            "{:.1f}MB".format((e.get("spill_bytes") or 0) / 1e6),
            "{:.1f}MB".format((e.get("exchange_sent_bytes") or 0) / 1e6),
            "{:.1f}MB".format(
                (e.get("exchange_received_bytes") or 0) / 1e6),
            e.get("verdict") or "?"))
    skew = section.get("skew")
    if skew:
        add("skew: {} step(s) · mean {:.0%} / max {:.0%} of step wall · "
            "fleet waited {:.3f}s on stragglers".format(
                len(skew.get("steps") or ()), skew.get("mean_fraction", 0),
                skew.get("max_fraction", 0), skew.get("skew_seconds", 0)))
        add("straggler: rank {} (enters collectives {:.2f}x later than "
            "the fleet average)".format(
                skew.get("straggler_rank"), skew.get("late_ratio", 1.0)))
    ex = section.get("exchange")
    if ex:
        add("exchange: {} over {} device(s); rank sent matrix "
            "(bytes): {}".format(
                "{:.1f}MB".format((ex.get("bytes") or 0) / 1e6),
                ex.get("devices"), ex.get("rank_sent_matrix")))
    mt = section.get("merged_trace_file")
    if mt:
        add("merged trace: {}  (load in https://ui.perfetto.dev)".format(
            mt))
    return "\n".join(lines)


def main(argv=None):
    """``python -m dampr_tpu_torch.obs.fleet <run>``: merge and print."""
    import argparse

    ap = argparse.ArgumentParser(
        description="merge a multi-process run's per-rank traces into "
                    "one Perfetto timeline + fleet stats section")
    ap.add_argument("run", help="run name, run scratch dir, or trace dir")
    ap.add_argument("--json", action="store_true",
                    help="emit the fleet section as JSON")
    ap.add_argument("--no-write", action="store_true",
                    help="compute only; do not persist the merged trace")
    args = ap.parse_args(argv)
    section = merge_run(args.run, write=not args.no_write)
    if args.json:
        print(json.dumps(section, indent=2, sort_keys=True))
    else:
        print(format_fleet(section))
    return 0 if section else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
