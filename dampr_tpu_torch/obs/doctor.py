"""The doctor: a run's telemetry read back as a ranked diagnosis.

Port of ``dampr_tpu/obs/doctor.py``.  The obs plane records what
happened (spans, counters), the critical-path analyzer says what bound
each stage (:mod:`.critpath`), the profiler which user op the time went
to (:mod:`.profile`), the history corpus how the run compares with
earlier ones (:mod:`.history`), and the sentry whether its telemetry
regressed (:mod:`.sentry`).  This module reads all of it back and
answers: why was this run slow, and which knob moves it?

Each finding ties a verdict to knobs the port has (a setting, or a
module constant :func:`.history.knob_value` reads), each with the
``DAMPR_TPU_TORCH_*`` variable the port reads it from, ranked by its
estimated wall-time impact::

    $ python -m dampr_tpu_torch.cli doctor bench-tfidf
    run bench-tfidf: 2.41s wall · bottleneck: codec
    1. [high] stage 1 (map, 1.2s): codec covers 61% of stage wall
       -> settings.lower (DAMPR_TPU_TORCH_LOWER): ...

The playbook keeps every verdict of the JAX package's.  The knobs the
port does not have (:data:`MESH_KNOBS`: spill and placement knobs the
port keeps fixed) are left out.

``--diff A B`` compares two runs; ``--json`` emits the report in the
JAX package's schema (``dampr-tpu-doctor/1``, ``docs/doctor_schema.json``);
``--autotune`` runs an autotune session (:mod:`.autotune`).
"""

import json

from .. import settings

SCHEMA = "dampr-tpu-doctor/1"

#: The JAX playbook's knobs the port does not have: spill and placement
#: knobs the port keeps fixed.
MESH_KNOBS = ("lower_min_records", "spill_inflight_bytes",
              "spill_read_threads")

#: Bottleneck taxonomy -> suggestions: (knob, the variable the port reads
#: it from or "", proposal from the current value, why).  Every knob is
#: one of the port's (pinned by a test).
_PLAYBOOK = {
    "spill-queue": [
        ("spill_write_threads", "DAMPR_TPU_TORCH_SPILL_WRITERS",
         lambda cur: max(4, int(cur or 0) * 2),
         "spill writes queue behind the writer pool — more writer "
         "threads drain the backlog before folds block on it"),
    ],
    "io-read": [
        ("spill_read_prefetch", "DAMPR_TPU_TORCH_SPILL_PREFETCH",
         lambda cur: max(4, int(cur or 0) * 2),
         "merge/final reads outran the frame prefetcher — deeper "
         "readahead overlaps decode with consumption"),
    ],
    "overlap-stall": [
        ("overlap_windows", "DAMPR_TPU_TORCH_OVERLAP_WINDOWS",
         lambda cur: max(4, int(cur or 0) * 2),
         "every live fold consumer was blocked on its codec producer — "
         "deeper overlap windows keep folds fed"),
    ],
    "pipeline-stall": [
        ("pipeline_queue_bytes", "DAMPR_TPU_TORCH_PIPELINE_QUEUE",
         lambda cur: None,
         "streamed-edge publishes blocked on the folder's backpressure "
         "bound (default budget/4) — a larger queue lets map jobs run "
         "further ahead of the early-fold consumer"),
        ("pipeline", "DAMPR_TPU_TORCH_PIPELINE",
         lambda cur: "0",
         "if the stalls outweigh the overlap the edge buys, the kill "
         "switch restores fully staged execution byte-identically"),
    ],
    "codec": [
        ("lower", "DAMPR_TPU_TORCH_LOWER",
         lambda cur: "1",
         "host decode/tokenize bounds the stage and it is "
         "device-eligible — the jitted program moves tokenize+hash+fold "
         "off the host codec"),
        ("scan_window_bytes", "",
         lambda cur: None,
         "larger line-aligned scan windows amortize per-window codec "
         "fixed costs (at the cost of window-sized RSS)"),
    ],
    "fold": [
        ("mesh_fold", "DAMPR_TPU_TORCH_MESH_FOLD",
         lambda cur: "on",
         "map-side folds bound the stage — the mesh collective fold "
         "path spreads keyed folds across devices"),
    ],
    "merge": [
        ("merge_fanin", "DAMPR_TPU_TORCH_MERGE_FANIN",
         lambda cur: max(64, int(cur or 0) * 2),
         "merge generations bound the run — higher fan-in merges more "
         "runs per pass (memory budget permitting)"),
        ("spill_read_prefetch", "DAMPR_TPU_TORCH_SPILL_PREFETCH",
         lambda cur: max(4, int(cur or 0) * 2),
         "deeper frame readahead keeps the k-way merge fed"),
    ],
    "spill-write": [
        ("max_memory_per_stage", "",
         lambda cur: int(cur or 0) * 2,
         "spill disk bandwidth bounds the run — a larger stage budget "
         "spills fewer bytes in the first place"),
        ("spill_codec", "DAMPR_TPU_TORCH_SPILL_CODEC",
         lambda cur: "zstd" if str(cur) != "zstd" else "lz4",
         "a faster/denser frame codec moves fewer bytes through the "
         "same disk"),
    ],
    "transfer": [
        ("lower_batch", "DAMPR_TPU_TORCH_LOWER_BATCH",
         lambda cur: int(cur or 0) * 2,
         "h2d/d2h movement bounds device stages — larger program "
         "batches amortize per-dispatch transfer"),
        ("hbm_budget", "DAMPR_TPU_TORCH_HBM_BUDGET",
         lambda cur: None,
         "a larger HBM residency budget keeps reduce-feeding lanes on "
         "device instead of round-tripping"),
    ],
    "device": [
        ("lower_batch", "DAMPR_TPU_TORCH_LOWER_BATCH",
         lambda cur: int(cur or 0) * 2,
         "device programs bound the run — larger batches amortize "
         "dispatch overhead per token"),
    ],
    # Cross-stage device handoff declined (or degraded mid-run) while
    # transfer/device work bounds the run: the knobs that fund / admit
    # the HBM-resident edge (docs/plan.md "Cross-stage device fusion").
    "handoff": [
        ("handoff", "DAMPR_TPU_TORCH_HANDOFF",
         lambda cur: None,
         "the tier's own switch: auto declines when the run's config "
         "disables lowering or zeroes the HBM budget — on forces the "
         "edge resident"),
        ("hbm_budget", "DAMPR_TPU_TORCH_HBM_BUDGET",
         lambda cur: None,
         "a funded HBM residency budget lets lowered producer outputs "
         "stay device-resident into the consuming fold instead of "
         "round-tripping through host spill"),
    ],
    "host-compute": [
        ("max_processes", "",
         lambda cur: None,
         "uninstrumented host work (opaque UDFs / Python glue) bounds "
         "the stage — profile it (DAMPR_TPU_TORCH_PROFILE=1) to see which op, "
         "and check worker-thread width"),
    ],
    "skew": [
        ("mitigate", "DAMPR_TPU_TORCH_MITIGATE",
         lambda cur: "on",
         "act on the skew instead of diagnosing it: the mitigation "
         "controller steals work from backlogged queues, speculatively "
         "re-executes straggler jobs (first-result-wins, exactly-once "
         "under attempt-scoped commits), degrades collective exchanges "
         "in place while a rank is late, and down-weights a "
         "persistently pathological rank's partition share for the "
         "rest of the run"),
        ("speculate_threshold", "DAMPR_TPU_TORCH_SPECULATE_THRESHOLD",
         lambda cur: None,
         "how many times slower than its peers (vs the other ranks' "
         "mean entry lateness + the 20 ms jitter floor; for host jobs, "
         "vs the median job duration) a worker must run before "
         "mitigation engages — lower it to act on milder skew, raise "
         "it if mitigation flaps on jitter"),
        ("speculate_after_steps", "DAMPR_TPU_TORCH_SPECULATE_AFTER",
         lambda cur: None,
         "consecutive pathological windows before engaging (and "
         "healthy probes before disengaging) — the debounce between "
         "acting fast and acting on noise"),
        ("exchange_coding", "DAMPR_TPU_TORCH_EXCHANGE_CODING",
         lambda cur: "camr",
         "coded aggregation for sum-combinable keyed folds: pre-fold "
         "each exchange window per destination partition so fewer "
         "bytes serialize on the slow rank's steps (replicated "
         "map-side fold work traded for shuffle bytes)"),
        ("spill_read_prefetch", "DAMPR_TPU_TORCH_SPILL_PREFETCH",
         lambda cur: max(4, int(cur or 0) * 2),
         "the straggler rank arrives late at collective steps — deeper "
         "frame readahead on that rank overlaps its decode with the "
         "fleet's compute so it reaches the barrier with everyone else"),
        ("partitions", "",
         lambda cur: None,
         "rebalance partitions: persistent per-rank lateness with a "
         "lopsided exchange send/recv matrix means some ranks carry "
         "more bytes per step than others"),
        ("exchange_hbm_budget", "DAMPR_TPU_TORCH_EXCHANGE_HBM",
         lambda cur: max(64 * 1024 ** 2, int(cur or 0) * 2),
         "fewer, larger collective steps amortize the per-step entry "
         "spread when skew is jitter rather than a persistent straggler"),
    ],
    "fault-retry": [
        ("job_retries", "DAMPR_TPU_TORCH_JOB_RETRIES",
         lambda cur: max(3, int(cur or 0)),
         "jobs failed and re-executed — a deeper retry budget absorbs "
         "longer flaky-IO bursts (transient failures back off with "
         "jitter between attempts)"),
        ("retry_backoff_ms", "DAMPR_TPU_TORCH_RETRY_BACKOFF_MS",
         lambda cur: max(100, int(cur or 0) * 2),
         "a retry STORM (many retries, little progress) wants a longer "
         "backoff base so attempts decorrelate from the failing "
         "resource's recovery window"),
        ("io_retries", "DAMPR_TPU_TORCH_IO_RETRIES",
         lambda cur: max(4, int(cur or 0) * 2),
         "transient spill-IO failures are absorbed inside the IO layer "
         "— a deeper in-place budget keeps them from surfacing as job "
         "failures at all"),
    ],
    "quarantine": [
        ("max_quarantined", "DAMPR_TPU_TORCH_MAX_QUARANTINED",
         lambda cur: None,
         "poison records were skipped into the quarantine sink — raise "
         "the budget if more are expected, or set 0 to fail fast and "
         "fix the data; the sink file lists every skipped record"),
        ("job_retries", "DAMPR_TPU_TORCH_JOB_RETRIES",
         lambda cur: None,
         "deterministic record failures are NOT healed by retries — "
         "inspect quarantine.jsonl and fix the records or the UDF"),
    ],
    "exchange-timeout": [
        ("exchange_timeout_ms", "DAMPR_TPU_TORCH_EXCHANGE_TIMEOUT_MS",
         lambda cur: max(60000, int(cur or 0) * 2),
         "a collective exchange step hit its deadline and the run "
         "aborted — raise the deadline if the fleet was merely slow; "
         "the shuffle stays degraded to host until faults.jsonl is "
         "cleared"),
        ("exchange_hbm_budget", "DAMPR_TPU_TORCH_EXCHANGE_HBM",
         lambda cur: max(64 * 1024 ** 2, int(cur or 0) * 2),
         "fewer, larger collective steps shrink the window in which a "
         "rank death can strand a step (and amortize per-step cost)"),
        ("mesh_exchange", "DAMPR_TPU_TORCH_MESH_EXCHANGE",
         lambda cur: "off",
         "or pin every redistribution to the host shuffle while the "
         "fleet is unstable"),
    ],
    "mesh": [
        ("exchange_hbm_budget", "DAMPR_TPU_TORCH_EXCHANGE_HBM",
         lambda cur: max(64 * 1024 ** 2, int(cur or 0) * 2),
         "collective exchange steps bound the run — a larger in-flight "
         "budget lets the replan schedule move the same bytes in fewer, "
         "bigger chunked collectives (device memory permitting)"),
        ("exchange_chunk_bytes", "DAMPR_TPU_TORCH_EXCHANGE_CHUNK",
         lambda cur: None,
         "or pin the per-piece chunk size explicitly when the device is "
         "memory-pressured beyond what the in-flight model captures "
         "(smaller chunks = more steps, lower peak)"),
        ("exchange_min_bytes", "DAMPR_TPU_TORCH_EXCHANGE_MIN_BYTES",
         lambda cur: max(4 * 1024 ** 2, int(cur or 0) * 2),
         "tiny shuffles pay D*D pack/unpack fixed costs — a higher "
         "floor keeps them on the host path (auto mode; explicit "
         "DAMPR_TPU_TORCH_MESH_EXCHANGE=off pins every stage host)"),
        ("shuffle_capacity_factor", "",
         lambda cur: None,
         "for the associative collective fold, tune exchange capacity "
         "or keep the shuffle on host (DAMPR_TPU_TORCH_MESH_EXCHANGE=off)"),
    ],
    "reuse-thrash": [
        ("reuse_budget_bytes", "DAMPR_TPU_TORCH_REUSE_BUDGET",
         lambda cur: max(2 * 1024 ** 3, int(cur or 0) * 2),
         "the shared materialization cache evicted entries as fast as "
         "it published them — a larger byte budget lets warm prefixes "
         "survive to the next run instead of churning"),
        ("reuse_dir", "DAMPR_TPU_TORCH_REUSE_DIR",
         lambda cur: None,
         "or point the cache at a volume with room: eviction pressure "
         "often means the scratch filesystem is shared with spill "
         "traffic"),
    ],
    "reuse-off": [
        ("reuse", "DAMPR_TPU_TORCH_REUSE",
         lambda cur: "on",
         "the run corpus shows this exact plan shape executed before — "
         "with the cross-run cache enabled, unchanged stage prefixes "
         "mount from disk instead of recomputing"),
    ],
}

#: Verdicts that never produce a finding on their own.
_BENIGN = ("idle", "checkpoint")


class DoctorError(Exception):
    pass


def _severity(impact_seconds, wall):
    if wall <= 0:
        return "low"
    frac = impact_seconds / wall
    if frac >= 0.25:
        return "high"
    if frac >= 0.10:
        return "medium"
    return "low"


def _run_settings(summary, hist_records):
    """The DIAGNOSED RUN's settings values, not the doctor process's:
    the history corpus snapshots the performance knobs per run, and the
    summary itself records the authoritative ones (io.writer_threads,
    overlap.windows, the sampler cadence).  A doctor invoked in a
    different environment must not compute 'current -> suggested' from
    its own defaults."""
    out = dict((hist_records[-1].get("settings") or {})
               if hist_records else {})
    io = summary.get("io") or {}
    if io.get("writer_threads") is not None:
        out["spill_write_threads"] = io["writer_threads"]
    if io.get("read_prefetch") is not None:
        out["spill_read_prefetch"] = io["read_prefetch"]
    ov = summary.get("overlap") or {}
    if ov.get("windows") is not None:
        out["overlap_windows"] = ov["windows"]
    sm = (summary.get("metrics") or {}).get("sampler") or {}
    if sm.get("interval_ms"):
        out["metrics_interval_ms"] = sm["interval_ms"]
    dev = summary.get("device") or {}
    if dev.get("lowered") is not None:
        out.setdefault("lower", "1" if dev["lowered"] else str(
            settings.lower))
    return out


def _suggestions_for(verdict, summary, stage_entry=None,
                     run_settings=None):
    out = []
    run_settings = run_settings or {}
    for knob, env, propose, why in _PLAYBOOK.get(verdict, ()):
        if verdict == "codec" and knob == "lower":
            # Only suggest lowering when an eligible host stage exists:
            # the plan report records per-stage decisions with reasons.
            if not _has_lowerable_host_stage(summary, stage_entry):
                continue
        cur = _current(knob, run_settings)
        try:
            proposed = propose(cur)
        except (TypeError, ValueError):
            proposed = None
        sug = {
            "setting": knob,
            "current": cur if _jsonable(cur) else str(cur),
            "suggested": proposed if _jsonable(proposed) else str(proposed),
            "why": why,
        }
        if env:  # omitted (not null) when the knob has no env var —
            sug["env"] = env  # the schema types env as a string
        out.append(sug)
    return out


def _current(knob, run_settings):
    """The diagnosed run's value of a knob, else this process's."""
    from . import history

    if knob in run_settings:
        return run_settings[knob]
    return history.knob_value(knob)


def _jsonable(v):
    return v is None or isinstance(v, (bool, int, float, str))


def _has_lowerable_host_stage(summary, stage_entry=None):
    """Is there a host-executed map stage the lowering pass would (or
    could) place on device?  True when lowering was off entirely, or a
    host decision's reason shows eligibility was only blocked by
    history/settings."""
    lowering = ((summary.get("plan") or {}).get("lowering")) or {}
    if not lowering.get("enabled"):
        # Lowering never ran (off / auto-off on CPU): a codec-bound
        # scanner stage MAY be eligible — worth the suggestion.
        return True
    sids = None
    if stage_entry is not None and stage_entry.get("stage") is not None:
        sids = {stage_entry["stage"]}
    for d in lowering.get("targets") or ():
        if sids is not None and d.get("sid") not in sids:
            continue
        if d.get("target") == "host" and "history:" in (d.get("reason")
                                                        or ""):
            return True
    return False


def _stage_kind(summary, sid):
    for st in summary.get("stages") or ():
        if st.get("stage") == sid:
            return st
    return {}


def diagnose(run):
    """Build the full report dict for one run (name / run dir / stats
    path).  Raises DoctorError when no stats exist."""
    from . import critpath, flightrec, history

    section, summary = critpath.from_run(run)
    if summary is None:
        raise DoctorError(
            "no stats.json found for {!r}: doctor reads a finalized "
            "run's artifacts (traced runs persist them — "
            "DAMPR_TPU_TORCH_TRACE=1)".format(run))
    wall = summary.get("wall_seconds") or 0.0
    # Rank-tagged corpus records (non-zero ranks of a fleet run) carry
    # rank-local settings/timings — the diagnosis baseline is the
    # run-level (rank-0) trail.
    hist = [r for r in history.load(summary.get("run"))
            if not r.get("rank")]
    run_settings = _run_settings(summary, hist)
    findings = []

    # -- per-stage verdicts --------------------------------------------------
    stage_entries = []
    for s in (section or {}).get("stages") or ():
        sid = s.get("stage")
        st = _stage_kind(summary, sid)
        entry = {
            "stage": sid,
            "kind": s.get("kind") or st.get("kind"),
            "target": st.get("target", "host"),
            "seconds": s.get("seconds"),
            "verdict": s.get("verdict"),
            "fractions": s.get("fractions") or {},
        }
        stage_entries.append(entry)
        verdict = s.get("verdict")
        if verdict in _BENIGN or verdict is None:
            continue
        frac = (s.get("fractions") or {}).get(verdict, 0.0)
        sec = (s.get("seconds") or 0.0) * frac
        if sec <= 0:
            continue
        sugg = _suggestions_for(verdict, summary, entry, run_settings)
        findings.append({
            "stage": sid,
            "bottleneck": verdict,
            "impact_seconds": round(sec, 4),
            "severity": _severity(sec, wall),
            "evidence": "stage {} ({}, {:.2f}s): {} covers {:.0%} of "
                        "stage wall".format(
                            sid, entry["kind"], s.get("seconds") or 0.0,
                            verdict, frac),
            "suggestions": sugg,
        })

    # -- run-level signals the per-stage windows can miss --------------------
    # Only where no per-stage finding already names the same verdict: a
    # stage-level spill-queue finding and its run-level mirror are ONE
    # root cause — double-reporting would rank the same seconds twice
    # and demote genuinely distinct second-place bottlenecks.
    staged_verdicts = {f["bottleneck"] for f in findings}
    io = summary.get("io") or {}
    if ("spill-queue" not in staged_verdicts
            and (io.get("io_wait_write_fraction") or 0.0) > 0.05):
        # io_wait_write_seconds is THREAD-seconds (concurrently blocked
        # folds each add their own wait); impact must be on the same
        # wall-clock axis the stage findings rank on, so clamp the
        # fraction at 1 and charge wall time.
        frac = min(1.0, io["io_wait_write_fraction"])
        sec = frac * wall
        findings.append({
            "stage": None,
            "bottleneck": "spill-queue",
            "impact_seconds": round(sec, 4),
            "severity": _severity(sec, wall),
            "evidence": "folds spent {:.2f} thread-seconds blocked on "
                        "writer-pool backpressure ({:.0%} of wall, "
                        "clamped)".format(
                            io.get("io_wait_write_seconds") or sec, frac),
            "suggestions": _suggestions_for("spill-queue", summary,
                                            run_settings=run_settings),
        })
    ov = summary.get("overlap") or {}
    if ("overlap-stall" not in staged_verdicts
            and (ov.get("stall_fraction") or 0.0) > 0.15):
        sec = min(1.0, ov["stall_fraction"]) * wall
        findings.append({
            "stage": None,
            "bottleneck": "overlap-stall",
            "impact_seconds": round(sec, 4),
            "severity": _severity(sec, wall),
            "evidence": "codec_wait union covered {:.0%} of wall — every "
                        "live fold consumer was starved by its codec "
                        "producer".format(ov["stall_fraction"]),
            "suggestions": _suggestions_for("overlap-stall", summary,
                                            run_settings=run_settings),
        })
    met = (summary.get("metrics") or {}).get("sampler") or {}
    if (met.get("overhead") or 0.0) > 0.03:
        sec = min(1.0, met["overhead"]) * wall
        interval = (run_settings.get("metrics_interval_ms")
                    or met.get("interval_ms") or 100)
        findings.append({
            "stage": None,
            "bottleneck": "host-compute",
            "impact_seconds": round(sec, 4),
            "severity": "low",
            "evidence": "metrics sampler overhead {:.2%} exceeds the 3% "
                        "budget".format(met["overhead"]),
            "suggestions": [{
                "setting": "metrics_interval_ms",
                "env": "DAMPR_TPU_TORCH_METRICS_MS",
                "current": interval,
                "suggested": max(200, interval * 4),
                "why": "a longer sampling cadence bounds sampler cost",
            }],
        })

    # -- declined device handoff while transfer/device bounds the run --------
    # The plan saw a device->device edge but spilled it, or the runtime
    # degraded the edge mid-stage; if transfer or device work then
    # dominated, the handoff/HBM-budget knobs are the lever (ROADMAP 5b,
    # docs/plan.md "Cross-stage device fusion").  Only ACTIONABLE
    # declines count, by the edge's typed `kind`: "settings" (the
    # handoff/budget knobs directly) and "no-device-consumer" (a lower
    # placement floor can lower the consumer).  "object-lane" has no
    # device tier to buy, and a "priced" decline is the cost model
    # already choosing the faster path — suggesting knobs against its
    # evidence would be noise.
    verdicts = {f["bottleneck"] for f in findings}
    verdicts.add(((section or {}).get("run") or {}).get("verdict"))
    for s in (section or {}).get("stages") or ():
        verdicts.add(s.get("verdict"))
    dev = summary.get("device") or {}
    declined = [
        e for e in (((summary.get("plan") or {}).get("lowering") or {})
                    .get("handoff") or ())
        if e.get("handoff") == "spill"
        and e.get("kind") in ("settings", "no-device-consumer")]
    degrades = dev.get("handoff_degrades") or 0
    if (verdicts & {"transfer", "device"}) and (declined or degrades):
        rf = ((section or {}).get("run") or {}).get("fractions") or {}
        frac = min(1.0, (rf.get("transfer") or 0.0)
                   + (rf.get("device") or 0.0))
        sec = (frac or 0.05) * wall
        if declined:
            ev = ("transfer/device work bounds the run and {} device "
                  "handoff edge(s) were declined ({})".format(
                      len(declined), declined[0].get("reason")))
        else:
            ev = ("transfer/device work bounds the run and the device "
                  "handoff degraded to the spill path {} time(s) "
                  "mid-run".format(degrades))
        findings.append({
            "stage": None,
            "bottleneck": "handoff",
            "impact_seconds": round(sec, 4),
            "severity": _severity(sec, wall),
            "evidence": ev,
            "suggestions": _suggestions_for("handoff", summary,
                                            run_settings=run_settings),
        })

    # -- fleet verdicts (multi-process runs with a merged timeline) ----------
    fleet = summary.get("fleet") or {}
    fleet_report = None
    if (fleet.get("num_processes") or 1) > 1:
        skew = fleet.get("skew") or {}
        straggler = skew.get("straggler_rank")
        fleet_report = {
            "num_processes": fleet.get("num_processes"),
            "ranks": fleet.get("ranks"),
            "missing_ranks": fleet.get("missing_ranks") or [],
            "alignment": fleet.get("alignment"),
            "straggler_rank": straggler,
            "late_ratio": skew.get("late_ratio"),
            "mean_step_skew_fraction": skew.get("mean_fraction"),
            "max_step_skew_fraction": skew.get("max_fraction"),
            "skew_seconds": skew.get("skew_seconds"),
            "per_rank": [
                {k: v for k, v in e.items() if v is not None}
                for e in fleet.get("per_rank") or ()],
        }
        # Schema discipline: typed optional keys are omitted, not null.
        fleet_report = {k: v for k, v in fleet_report.items()
                        if v is not None}
        mitigation = fleet.get("mitigation") or summary.get("mitigation")
        if mitigation:
            fleet_report["mitigation"] = mitigation
        sec = skew.get("skew_seconds") or 0.0
        # A skew finding is worth ranking when the fleet measurably
        # waited: spreads covering >=5% of wall, or any step where the
        # entry spread dominated the step (a hard straggler signature).
        if (wall > 0 and straggler is not None
                and (sec / wall > 0.05
                     or (skew.get("max_fraction") or 0.0) >= 0.5)):
            straggler_verdict = None
            for e in fleet.get("per_rank") or ():
                if e.get("rank") == straggler:
                    straggler_verdict = e.get("verdict")
            evidence = ("rank {} enters collective steps {:.1f}x later "
                        "than the fleet average (entry spread covered "
                        "{:.0%} of step wall over {} step(s); the fleet "
                        "waited {:.2f}s on it)".format(
                            straggler, skew.get("late_ratio") or 1.0,
                            skew.get("mean_fraction") or 0.0,
                            len(skew.get("steps") or ()), sec))
            if straggler_verdict and straggler_verdict not in (
                    "idle", "host-compute"):
                evidence += ("; that rank's own bottleneck is {} — fix "
                             "it there first".format(straggler_verdict))
            mit = fleet.get("mitigation") or summary.get("mitigation")
            if mit and mit.get("engagements"):
                evidence += (
                    "; mitigation ACTED on it ({} engagement(s), {} "
                    "collective window(s) degraded in place, {} "
                    "speculative win(s), {} stolen partition(s){})"
                    .format(
                        mit.get("engagements"),
                        mit.get("windows_skipped") or 0,
                        mit.get("speculative_wins") or 0,
                        mit.get("stolen_partitions") or 0,
                        ", down-weighted rank(s) {}".format(
                            sorted(mit["downweighted_ranks"],
                                   key=lambda r: int(r)))
                        if mit.get("downweighted_ranks") else ""))
            elif mit:
                evidence += ("; mitigation was armed but never engaged "
                             "(late_ratio stayed under "
                             "speculate_threshold for "
                             "speculate_after_steps windows)")
            findings.append({
                "stage": None,
                "bottleneck": "skew",
                "impact_seconds": round(min(sec, wall), 4),
                "severity": _severity(min(sec, wall), wall),
                "evidence": evidence,
                "suggestions": _suggestions_for(
                    "skew", summary, run_settings=run_settings),
            })
        for missing in fleet_report["missing_ranks"]:
            findings.append({
                "stage": None,
                "bottleneck": "skew",
                "impact_seconds": 0.0,
                "severity": "high",
                "evidence": "rank {} left no artifacts — it was killed "
                            "or never finished (check its crashdump: "
                            "crashdump.rank{}.json)".format(
                                missing, missing),
                "suggestions": [],
            })

    # -- failure-recovery signals (dampr_tpu_torch.faults) ------------------
    from .. import faults as _faults_mod

    fa = summary.get("faults") or {}
    events = _faults_mod.load_events(summary.get("run"))
    timeouts = [ev for ev in events if ev.get("kind") == "exchange_timeout"]
    retries = fa.get("retries") or 0
    quarantined = fa.get("quarantined") or 0
    backoff_s = fa.get("backoff_seconds") or 0.0
    if retries:
        sec = min(backoff_s, wall) if wall > 0 else backoff_s
        io_r = fa.get("io_retries") or {}
        findings.append({
            "stage": None,
            "bottleneck": "fault-retry",
            "impact_seconds": round(sec, 4),
            "severity": _severity(sec, wall) if sec else "low",
            "evidence": "{} classified retries absorbed ({} job "
                        "re-execution(s), {} in-place IO retr{}), "
                        "{:.2f}s spent backing off".format(
                            retries, fa.get("job_retries") or 0,
                            sum(io_r.values()),
                            "y" if sum(io_r.values()) == 1 else "ies",
                            backoff_s),
            "suggestions": _suggestions_for("fault-retry", summary,
                                            run_settings=run_settings),
        })
    if quarantined:
        findings.append({
            "stage": None,
            "bottleneck": "quarantine",
            "impact_seconds": 0.0,
            "severity": "medium",
            "evidence": "{} poison record(s) quarantined (budget "
                        "max_quarantined={}) — the stage completed "
                        "without them; inspect {}".format(
                            quarantined, fa.get("max_quarantined"),
                            fa.get("quarantine_file")
                            or "the quarantine sink"),
            "suggestions": _suggestions_for("quarantine", summary,
                                            run_settings=run_settings),
        })
    if timeouts:
        stages_to = sorted({ev.get("stage") for ev in timeouts
                            if ev.get("stage") is not None})
        findings.append({
            "stage": stages_to[0] if len(stages_to) == 1 else None,
            "bottleneck": "exchange-timeout",
            "impact_seconds": 0.0,
            "severity": "high",
            "evidence": "{} recorded collective exchange timeout(s)"
                        "{} — surviving ranks aborted with crashdumps; "
                        "affected stages stay degraded to the host "
                        "shuffle until faults.jsonl is cleared".format(
                            len(timeouts),
                            " at stage(s) {}".format(stages_to)
                            if stages_to else ""),
            "suggestions": _suggestions_for("exchange-timeout", summary,
                                            run_settings=run_settings),
        })

    # -- cross-run materialization cache signals (plan/reuse.py) -------------
    reuse = summary.get("reuse") or {}
    if reuse.get("enabled"):
        hits = reuse.get("hits") or 0
        evictions = reuse.get("evictions") or 0
        # Thrash: the run published into the cache but eviction churned
        # at least as much as lookups hit — the budget is too small for
        # the working set, so the NEXT run's prefixes won't be there.
        if evictions and evictions >= max(1, hits):
            findings.append({
                "stage": None,
                "bottleneck": "reuse-thrash",
                "impact_seconds": 0.0,
                "severity": "medium",
                "evidence": "reuse cache evicted {} entr{} against {} "
                            "hit(s) this run ({:.1f} MB published) — "
                            "the byte budget is churning the working "
                            "set".format(
                                evictions,
                                "y" if evictions == 1 else "ies", hits,
                                (reuse.get("bytes_published") or 0) / 1e6),
                "suggestions": _suggestions_for("reuse-thrash", summary,
                                                run_settings=run_settings),
            })
    elif hist:
        # Missed reuse: the corpus has PRIOR records of this exact plan
        # fingerprint, but the cache was off — an identical re-run would
        # have mounted its unchanged prefix instead of recomputing.
        fp = history.plan_fingerprint(
            (summary.get("plan") or {}).get("stage_shapes"))
        prior = [r for r in hist[:-1] if r.get("fingerprint") == fp]
        if fp and prior:
            findings.append({
                "stage": None,
                "bottleneck": "reuse-off",
                "impact_seconds": 0.0,
                "severity": "low",
                "evidence": "this plan shape has {} prior corpus "
                            "record(s) with an identical fingerprint "
                            "but the cross-run cache was disabled — "
                            "repeated runs recompute unchanged "
                            "prefixes".format(len(prior)),
                "suggestions": _suggestions_for("reuse-off", summary,
                                                run_settings=run_settings),
            })

    # -- long-horizon regressions (obs/sentry over the telemetry store) ------
    sentry_section = None
    if settings.sentry_window > 0:
        from . import sentry as _sentry

        sfindings = summary.get("sentry")
        if sfindings is None:
            sfindings = _sentry.check_run(summary.get("run"),
                                          summary=summary)
        if sfindings:
            sentry_section = {"findings": sfindings,
                              "window": _sentry.effective_window(),
                              "threshold": _sentry.effective_threshold()}
        for sf in sfindings or ():
            sugs = []
            if sf.get("setting"):
                cur = _current(sf["setting"], run_settings)
                sug = {"setting": sf["setting"],
                       "current": cur if _jsonable(cur) else str(cur),
                       "suggested": None,
                       "why": sf.get("why") or ""}
                if sf.get("env"):
                    sug["env"] = sf["env"]
                sugs.append(sug)
            findings.append({
                "stage": None,
                "bottleneck": "regression",
                "impact_seconds": 0.0,
                "severity": ("high" if abs(sf.get("z") or 0)
                             >= 2 * (sf.get("threshold") or 1)
                             else "medium"),
                "evidence": "{} regressed against its {}-run baseline: "
                            "{:g} vs median {:g} ({:+.1f} robust sigma, "
                            "plan {})".format(
                                sf.get("metric"), sf.get("window"),
                                sf.get("value"), sf.get("median"),
                                sf.get("z") or 0.0,
                                sf.get("fingerprint")),
                "suggestions": sugs,
            })

    findings.sort(key=lambda f: -(f.get("impact_seconds") or 0.0))
    for rank, f in enumerate(findings, 1):
        f["rank"] = rank

    fault_section = None
    if fa or events:
        fault_section = {
            "enabled": bool(fa.get("enabled")),
            "retries": retries,
            "job_retries": fa.get("job_retries") or 0,
            "io_retries": fa.get("io_retries") or {},
            "backoff_seconds": backoff_s,
            "quarantined": quarantined,
            "exchange_timeouts": len(timeouts),
        }
        if fa.get("max_quarantined") is not None:
            fault_section["max_quarantined"] = fa["max_quarantined"]
        if fa.get("quarantine_file"):
            fault_section["quarantine_file"] = fa["quarantine_file"]
        if fa.get("plan"):
            fault_section["plan"] = fa["plan"]
            fault_section["injected"] = fa.get("injected") or {}
        if events:
            fault_section["events"] = events[-10:]

    report = {
        "schema": SCHEMA,
        "run": summary.get("run"),
        "wall_seconds": wall,
        "bottleneck": ((section or {}).get("run") or {}).get("verdict"),
        "critpath_source": (section or {}).get("source"),
        "stages": stage_entries,
        "findings": findings,
        "history_entries": len(hist),
        "crashed": flightrec.locate_crashdump(run) is not None,
    }
    if fleet_report is not None:
        report["fleet"] = fleet_report
    if sentry_section is not None:
        report["sentry"] = sentry_section
    if fault_section is not None:
        report["faults"] = fault_section
    if summary.get("mitigation"):
        report["mitigation"] = summary["mitigation"]
    if summary.get("reuse"):
        report["reuse"] = summary["reuse"]
    return report


def _by_sid(summary):
    return {st.get("stage"): st for st in summary.get("stages") or ()}


def diff(run_a, run_b):
    """Comparison report for two runs: wall and per-stage deltas,
    verdict changes, and settings-snapshot differences (from each run's
    newest history-corpus record when available)."""
    from . import critpath, history

    sec_a, sum_a = critpath.from_run(run_a)
    sec_b, sum_b = critpath.from_run(run_b)
    if sum_a is None or sum_b is None:
        missing = run_a if sum_a is None else run_b
        raise DoctorError("no stats.json found for {!r}".format(missing))
    wall_a = sum_a.get("wall_seconds") or 0.0
    wall_b = sum_b.get("wall_seconds") or 0.0
    verd_a = {s.get("stage"): s.get("verdict")
              for s in (sec_a or {}).get("stages") or ()}
    verd_b = {s.get("stage"): s.get("verdict")
              for s in (sec_b or {}).get("stages") or ()}
    stages = []
    a_stages, b_stages = _by_sid(sum_a), _by_sid(sum_b)
    for sid in sorted(set(a_stages) | set(b_stages)):
        sa, sb = a_stages.get(sid) or {}, b_stages.get(sid) or {}
        stages.append({
            "stage": sid,
            "kind": sb.get("kind") or sa.get("kind"),
            "seconds_a": sa.get("seconds"),
            "seconds_b": sb.get("seconds"),
            "delta_seconds": (round(sb["seconds"] - sa["seconds"], 4)
                              if isinstance(sa.get("seconds"), (int, float))
                              and isinstance(sb.get("seconds"),
                                             (int, float)) else None),
            "verdict_a": verd_a.get(sid),
            "verdict_b": verd_b.get(sid),
        })

    def newest_settings(run_name):
        recs = history.load(run_name)
        return (recs[-1].get("settings") or {}) if recs else {}

    set_a = newest_settings(sum_a.get("run"))
    set_b = newest_settings(sum_b.get("run"))
    settings_delta = {
        k: {"a": set_a.get(k), "b": set_b.get(k)}
        for k in sorted(set(set_a) | set(set_b))
        if set_a.get(k) != set_b.get(k)
    }

    def mit_counts(s):
        m = s.get("mitigation") or {}
        if not m:
            return None
        out = {k: m.get(k) or 0 for k in (
            "engagements", "windows_skipped", "speculative_wins",
            "stolen_partitions")}
        out["downweighted_ranks"] = m.get("downweighted_ranks") or {}
        return out

    mit_a, mit_b = mit_counts(sum_a), mit_counts(sum_b)
    report = {
        "schema": SCHEMA,
        "run": "{} vs {}".format(sum_a.get("run"), sum_b.get("run")),
        "wall_seconds": wall_b,
        "bottleneck": ((sec_b or {}).get("run") or {}).get("verdict"),
        "critpath_source": (sec_b or {}).get("source"),
        "stages": [],
        "findings": [],
        "history_entries": 0,
        "crashed": False,
        "diff": {
            "run_a": sum_a.get("run"), "run_b": sum_b.get("run"),
            "wall_a": wall_a, "wall_b": wall_b,
            "wall_delta": round(wall_b - wall_a, 4),
            "wall_ratio": (round(wall_b / wall_a, 4) if wall_a > 0
                           else None),
            "stages": stages,
            "settings_delta": settings_delta,
        },
    }
    if mit_a or mit_b:
        # Mitigation deltas: what each run DID about its skew — next to
        # the knob deltas that changed the behavior.
        report["diff"]["mitigation"] = {"a": mit_a, "b": mit_b}
    return report


def format_report(report, show_faults=False):
    """Human-readable rendering.  ``show_faults`` (the ``--faults``
    flag) adds the failure-recovery section: classified retry counts,
    quarantine state, injection plan, and recorded exchange timeouts."""
    lines = []
    add = lines.append
    d = report.get("diff")
    if d:
        add("doctor diff: {} -> {}".format(d["run_a"], d["run_b"]))
        ratio = d.get("wall_ratio")
        add("wall: {:.2f}s -> {:.2f}s ({})".format(
            d["wall_a"], d["wall_b"],
            "{:+.1%}".format(ratio - 1) if ratio else "n/a"))
        for st in d["stages"]:
            line = "  stage {:>2} ({:<10}) {:>8} -> {:>8}".format(
                st["stage"], st.get("kind") or "?",
                "{:.2f}s".format(st["seconds_a"])
                if st.get("seconds_a") is not None else "-",
                "{:.2f}s".format(st["seconds_b"])
                if st.get("seconds_b") is not None else "-")
            if st.get("verdict_a") or st.get("verdict_b"):
                line += "   {} -> {}".format(st.get("verdict_a") or "?",
                                             st.get("verdict_b") or "?")
            add(line)
        if d["settings_delta"]:
            add("settings changed:")
            for k, v in sorted(d["settings_delta"].items()):
                add("  {}: {!r} -> {!r}".format(k, v["a"], v["b"]))
        else:
            add("settings: no recorded differences")
        md = d.get("mitigation")
        if md:
            def _fmt_mit(m):
                if not m:
                    return "off"
                return ("{} engagement(s), {} window(s) degraded, {} "
                        "speculative win(s), {} stolen".format(
                            m.get("engagements") or 0,
                            m.get("windows_skipped") or 0,
                            m.get("speculative_wins") or 0,
                            m.get("stolen_partitions") or 0))
            add("mitigation: {} -> {}".format(_fmt_mit(md.get("a")),
                                              _fmt_mit(md.get("b"))))
        return "\n".join(lines)

    add("run {}: {:.2f}s wall · bottleneck: {}".format(
        report.get("run"), report.get("wall_seconds") or 0.0,
        report.get("bottleneck") or "?"))
    if report.get("crashed"):
        add("NOTE: this run left a crashdump (it did not finish cleanly)")
    if report.get("critpath_source") == "summary":
        add("note: no span timeline — verdicts are stats-derived "
            "(trace the run for per-stage windows: DAMPR_TPU_TORCH_TRACE=1)")
    for st in report.get("stages") or ():
        fr = st.get("fractions") or {}
        top = ", ".join("{} {:.0%}".format(k, v) for k, v in sorted(
            fr.items(), key=lambda kv: -kv[1])[:3])
        add("  stage {:>2} ({:<10} {:>6}) {:>8}  {}  [{}]".format(
            st.get("stage"), st.get("kind") or "?",
            st.get("target") or "host",
            "{:.2f}s".format(st["seconds"])
            if st.get("seconds") is not None else "-",
            st.get("verdict") or "?", top))
    fl = report.get("fleet")
    if fl:
        line = "fleet: {} process(es)".format(fl.get("num_processes"))
        if fl.get("missing_ranks"):
            line += " · MISSING ranks {}".format(fl["missing_ranks"])
        if fl.get("straggler_rank") is not None:
            line += (" · straggler: rank {} ({:.1f}x late, mean step "
                     "skew {:.0%})".format(
                         fl["straggler_rank"], fl.get("late_ratio") or 1.0,
                         fl.get("mean_step_skew_fraction") or 0.0))
        add(line)
        for e in fl.get("per_rank") or ():
            add("  rank {:>2}: {:>8} wall · {} spill · verdict {}".format(
                e.get("rank"),
                "{:.2f}s".format(e["wall_seconds"])
                if e.get("wall_seconds") is not None else "-",
                "{:.1f}MB".format((e.get("spill_bytes") or 0) / 1e6),
                e.get("verdict") or "?"))
        mit = fl.get("mitigation")
        if mit:
            add("  mitigation: {} · {} engagement(s) · {} window(s) "
                "degraded in place · {} speculative win(s) · {} stolen "
                "partition(s){}".format(
                    "ENGAGED" if mit.get("engaged") else "disengaged",
                    mit.get("engagements") or 0,
                    mit.get("windows_skipped") or 0,
                    mit.get("speculative_wins") or 0,
                    mit.get("stolen_partitions") or 0,
                    " · down-weighted: {}".format({
                        r: mit["downweighted_ranks"][r]
                        for r in sorted(mit["downweighted_ranks"],
                                        key=lambda r: int(r))})
                    if mit.get("downweighted_ranks") else ""))
    if show_faults:
        fa = report.get("faults")
        if not fa:
            add("faults: nothing recorded (run predates the fault "
                "section, or stats.json is missing it)")
        else:
            io_r = fa.get("io_retries") or {}
            add("faults: {} retr{} ({} job re-execution(s), {} IO) · "
                "backoff {:.2f}s · quarantined {}{}".format(
                    fa.get("retries") or 0,
                    "y" if (fa.get("retries") or 0) == 1 else "ies",
                    fa.get("job_retries") or 0, sum(io_r.values()),
                    fa.get("backoff_seconds") or 0.0,
                    fa.get("quarantined") or 0,
                    "/{}".format(fa["max_quarantined"])
                    if fa.get("max_quarantined") is not None else ""))
            if fa.get("plan"):
                add("  injection plan: {!r} · injected: {}".format(
                    fa["plan"], fa.get("injected") or {}))
            if fa.get("quarantine_file"):
                add("  quarantine sink: {}".format(fa["quarantine_file"]))
            if fa.get("exchange_timeouts"):
                add("  exchange timeouts recorded: {} (stages degraded "
                    "to the host shuffle until faults.jsonl is "
                    "cleared)".format(fa["exchange_timeouts"]))
            for ev in fa.get("events") or ():
                add("  event: {}".format(json.dumps(ev, sort_keys=True)))
    if not report.get("findings"):
        add("no findings: nothing instrumented dominates — this run "
            "looks healthy at the recorded granularity")
    for f in report.get("findings") or ():
        add("{}. [{}] {}".format(f["rank"], f["severity"], f["evidence"]))
        for s in f.get("suggestions") or ():
            env = " ({})".format(s["env"]) if s.get("env") else ""
            tail = ("{!r} -> {!r}".format(s["current"], s["suggested"])
                    if s.get("suggested") is not None
                    else "current {!r}".format(s["current"]))
            add("   -> settings.{}{}: {}".format(s["setting"], env, tail))
            add("      {}".format(s["why"]))
    if report.get("history_entries"):
        add("history: {} recorded run(s) under this name "
            "(doctor --diff compares two)".format(
                report["history_entries"]))
    return "\n".join(lines)


def main(argv=None):
    """``python -m dampr_tpu_torch.cli doctor``."""
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="dampr_tpu_torch.cli doctor",
        description="diagnose a dampr_tpu_torch run: ranked bottlenecks "
                    "with concrete settings suggestions")
    ap.add_argument("run", help="run name, run scratch/trace directory, "
                                "or stats.json path")
    ap.add_argument("runs", nargs="*",
                    help="(with --diff) the second run; (with "
                         "--autotune) the pipeline command, after --")
    ap.add_argument("--diff", action="store_true",
                    help="compare two runs: doctor --diff RUN_A RUN_B")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report "
                         "(docs/doctor_schema.json)")
    ap.add_argument("--faults", action="store_true",
                    help="render the failure-recovery section: "
                         "classified retries, quarantine state, "
                         "injection plan, recorded exchange timeouts")
    ap.add_argument("--autotune", action="store_true",
                    help="closed-loop tuning: re-run the given pipeline "
                         "command under model-suggested knob vectors, "
                         "keep the fastest byte-identical winner, and "
                         "persist it (docs/tuning.md): doctor RUN "
                         "--autotune [--trials N] [--assert-dir D] "
                         "[--report TUNE.json] -- CMD ...")
    ap.add_argument("--trials", type=int, default=None,
                    help="(--autotune) measured trial budget, baseline "
                         "included (default settings.autotune_trials)")
    ap.add_argument("--assert-dir", default=None,
                    help="(--autotune) output directory whose content "
                         "digest must match trial 0 for a trial to "
                         "qualify (the byte-exactness witness)")
    ap.add_argument("--report", default=None,
                    help="(--autotune) write the schema-valid tuning "
                         "report here")
    # Everything after a literal ``--`` is the --autotune pipeline
    # command, verbatim (argparse's own ``--`` handling cannot keep an
    # option-looking command intact after optionals).
    if argv is None:
        argv = sys.argv[1:]
    command = None
    if "--" in argv:
        split = list(argv).index("--")
        command = list(argv[split + 1:])
        argv = list(argv[:split])
    args = ap.parse_args(argv)

    if args.autotune:
        from . import autotune as _autotune

        if command:
            args.runs = command
        return _autotune.main_autotune(args)
    if command:
        args.runs = (args.runs or []) + command
    try:
        if args.diff:
            if len(args.runs) != 1:
                ap.error("--diff takes exactly two runs")
            report = diff(args.run, args.runs[0])
        else:
            if args.runs:
                ap.error("one run expected (use --diff to compare two)")
            report = diagnose(args.run)
    except DoctorError as e:
        print("doctor: {}".format(e), file=sys.stderr)
        return 2
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(format_report(report, show_faults=args.faults))
    # A crashed run is a diagnosis, not a doctor failure — but scripts
    # should see it (the stats CLI's convention).
    return 3 if report.get("crashed") else 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
