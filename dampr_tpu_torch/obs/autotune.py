"""Closed-loop autotuning: measure the cost model's knob picks, keep the
winner, feed it back to the corpus.

Port of ``dampr_tpu/obs/autotune.py``, whole.  The learned cost model
(:mod:`..plan.model`) can only choose run-level knob values it has
observed; this loop makes the observations.  A session runs a pipeline
under a bounded series of knob vectors: trial 0 is the incoming
configuration, the others come from the model's variance search, the
doctor's playbook for the run's recorded verdict, and a fixed
exploration schedule.  Each trial's wall and throughput come from the
corpus record its run appended (that append is the write-back: the next
fit sees every measured vector).

- A trial whose output differs from trial 0's (:func:`dir_digest`) is
  disqualified and never crowned.
- The winner's vector persists to ``<scratch_root>/<RUN>/tuned.json``;
  the next run's cost layer (``plan.cost.load_tuned``) applies its
  ``n_partitions`` and ``explain()`` shows the rest.
- The session's report validates against ``docs/doctor_schema.json``
  (its ``autotune`` section) and ``tools/check_bench.py`` accepts it as a
  baseline.

Two forms: :func:`session` runs a command in a subprocess per trial and
exports each vector through the variables ``plan.model.ENV_OF`` names
(``python -m dampr_tpu_torch.cli doctor RUN --autotune -- CMD ...``);
:func:`tune_settings_session` is the in-process form the bench uses
under ``settings.autotune``, setting each knob where the port keeps it
(a setting, or a module constant: ``history.knob_home``) around the
measured call and restoring it after.
"""

import hashlib
import json
import logging
import os
import subprocess
import sys
import time

from .. import settings

log = logging.getLogger("dampr_tpu_torch.obs.autotune")

SCHEMA = "dampr-tpu-doctor/1"

#: Fixed exploration schedule: (knob, candidate-from-current) pairs
#: tried in order when the model has no variance evidence yet.  Each
#: thread-shaped knob explores the OPPOSITE regime first (on a 2-core
#: box background codec/writer threads contend with the fold; on a wide
#: box they win — only a measurement knows), then doubles.  Values are
#: clamped to plan.model.KNOB_BOUNDS before use.
_EXPLORE = (
    ("overlap_windows", lambda cur: 0 if cur else 2),
    ("spill_write_threads", lambda cur: 0 if cur else 2),
    ("spill_read_prefetch", lambda cur: 0 if cur else 2),
    ("overlap_windows", lambda cur: (cur or 1) * 2),
    ("spill_write_threads", lambda cur: (cur or 1) * 2),
    ("merge_fanin", lambda cur: (cur or 512) * 2),
)


def dir_digest(path, mode="lines"):
    """Content digest of every file under ``path`` — the byte-exactness
    witness between trials.  None when the directory is missing.

    ``mode="lines"`` (default) digests the sorted multiset of output
    LINES across all files: partition-count choices legitimately change
    how many part files a sink writes and which records land in which
    part, while the result — the line multiset — must be identical, so
    the witness must not be layout-sensitive.  ``mode="tree"`` digests
    relative paths + raw bytes (strict layout identity, for outputs
    where file boundaries are the contract)."""
    if not path or not os.path.isdir(path):
        return None
    if mode == "tree":
        h = hashlib.sha256()
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for fname in sorted(files):
                fpath = os.path.join(root, fname)
                h.update(os.path.relpath(fpath, path)
                         .encode("utf-8", "replace"))
                try:
                    with open(fpath, "rb") as f:
                        for chunk in iter(lambda: f.read(1 << 20), b""):
                            h.update(chunk)
                except OSError:
                    h.update(b"<unreadable>")
        return h.hexdigest()
    # Commutative multiset digest, O(1) memory: per-line sha256 values
    # sum mod 2^256 (order-free by construction), finalized with the
    # line count so the empty multiset and {""} differ.  Materializing
    # and sorting every line would cost GBs of RSS on the witnesses the
    # spill benches write.
    total = 0
    count = 0
    mod = 1 << 256
    for root, dirs, files in os.walk(path):
        dirs.sort()
        for fname in sorted(files):
            try:
                with open(os.path.join(root, fname), "rb") as f:
                    for ln in f:
                        total = (total + int.from_bytes(
                            hashlib.sha256(ln.rstrip(b"\n")).digest(),
                            "big")) % mod
                        count += 1
            except OSError:
                total = (total + int.from_bytes(
                    hashlib.sha256(b"<unreadable>").digest(),
                    "big")) % mod
                count += 1
    h = hashlib.sha256()
    h.update(count.to_bytes(8, "big"))
    h.update(total.to_bytes(32, "big"))
    return h.hexdigest()


def _corpus(run_name):
    from . import history

    return [r for r in history.load(run_name) if not r.get("rank")]


def _record_key(rec):
    return json.dumps(rec, sort_keys=True, default=str)


def _new_records(run_name, before_keys):
    """Records present now but not in the pre-trial snapshot — selected
    by CONTENT, not list position: at the settings.history_entries cap
    the corpus compacts on append, so its length stays constant while
    records churn, and positional slicing would report an empty
    delta."""
    return [r for r in _corpus(run_name)
            if _record_key(r) not in before_keys]


def _trial_measurement(new_records, fallback_wall):
    """(wall_seconds, mbps, n_partitions) for one trial from the corpus
    records its runs appended (benches run cold+warm under one name, so
    the best record is the trial's steady state), falling back to the
    subprocess wall when the command left no record."""
    walls = [r.get("wall_seconds") for r in new_records
             if isinstance(r.get("wall_seconds"), (int, float))]
    mbps = [
        (r.get("throughput") or {}).get("mbps")
        for r in new_records
        if isinstance((r.get("throughput") or {}).get("mbps"),
                      (int, float))]
    parts = [r.get("n_partitions") for r in new_records
             if isinstance(r.get("n_partitions"), int)]
    return (min(walls) if walls else fallback_wall,
            max(mbps) if mbps else None,
            parts[-1] if parts else None)


def candidate_vectors(run_name, max_candidates):
    """Bounded knob vectors to trial after the baseline, most promising
    first: model variance picks, the doctor playbook keyed on the run's
    recorded critpath verdict, then the static exploration schedule.
    Every value is clamped to the documented knob bounds; vectors keep
    settings-attribute keys (``as_env`` maps them for subprocesses)."""
    from ..plan import model as _model
    from .history import knob_value

    records = _corpus(run_name)
    vectors = []
    seen = set()

    def push(vec, why):
        vec = {k: v for k, v in vec.items()
               if _model.in_bounds(k, v) and v != knob_value(k)}
        if not vec:
            return
        key = json.dumps(vec, sort_keys=True, default=str)
        if key in seen or len(vectors) >= max_candidates:
            return
        seen.add(key)
        vectors.append({"knobs": vec, "why": why})

    if records:
        m = _model.build(records, records[-1].get("fingerprint"))
        current = {k: knob_value(k) for k in _model.VARIANCE_KNOBS}
        model_vec = {c["knob"]: c["chosen"]
                     for c in _model.search_variance_knobs(m, current)
                     if c.get("chosen") != c.get("static")}
        if model_vec:
            push(model_vec, "model: best-measured values over the "
                            "corpus variance")
        # Spill-aware exploration: a run that spilled through a
        # compressing codec should always get one raw-codec trial —
        # high-entropy numeric lanes often don't compress, and the
        # codec pass is core-bound either way (the measurement, not
        # this heuristic, decides).
        spilled = sum((st.get("spill_bytes") or 0)
                      for st in records[-1].get("stages") or ())
        cur_codec = str((records[-1].get("settings") or {})
                        .get("spill_codec", knob_value("spill_codec")))
        if spilled and cur_codec not in ("raw",):
            push({"spill_codec": "raw"},
                 "exploration: {} MB spilled through codec {!r} — "
                 "measure the raw frame path".format(
                     round(spilled / 1e6, 1), cur_codec))
        # Doctor playbook keyed on the newest record's critpath verdict.
        verdict = ((records[-1].get("critpath") or {}).get("run"))
        if verdict:
            from . import doctor as _doctor

            for knob, env, propose, _why in _doctor._PLAYBOOK.get(
                    verdict, ())[:2]:
                if knob not in _model.KNOB_BOUNDS:
                    continue
                cur = knob_value(knob)
                try:
                    proposed = propose(cur)
                except (TypeError, ValueError):
                    proposed = None
                if proposed is None:
                    continue
                if isinstance(proposed, (int, float)):
                    proposed = _model.clamp(knob, proposed)
                push({knob: proposed},
                     "doctor playbook for verdict {!r}".format(verdict))
    for knob, derive in _EXPLORE:
        cur = knob_value(knob)
        try:
            val = _model.clamp(knob, derive(cur))
        except (TypeError, ValueError):
            continue
        push({knob: val}, "exploration schedule")
    return vectors[:max_candidates]


def as_env(knobs):
    """Settings-keyed knob vector -> env-var map for a subprocess trial
    (knobs without an env var are dropped — they are engine-applied)."""
    from ..plan import model as _model

    out = {}
    for knob, val in (knobs or {}).items():
        env = _model.ENV_OF.get(knob)
        if env:
            out[env] = str(val)
    return out


def _persist_winner(run_name, session_id, winner):
    """Write the winner vector to ``<scratch_root>/<run>/tuned.json``
    (tmp + atomic rename; the cost layer's ``load_tuned`` reads it
    back).  Returns the path or None."""
    try:
        safe = str(run_name).replace("/", "_")
        run_dir = os.path.join(settings.scratch_root, safe)
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, "tuned.json")
        doc = {
            "schema": "dampr-tpu-tuned/1",
            "session": session_id,
            "run": run_name,
            "knobs": winner.get("knobs") or {},
            "wall_seconds": winner.get("wall_seconds"),
            "mbps": winner.get("mbps"),
            "trial": winner.get("trial"),
        }
        if winner.get("fingerprint"):
            # Plan-shape scope: the cost layer must never apply this
            # winner to a DIFFERENT pipeline that happens to reuse the
            # run name.
            doc["fingerprint"] = winner["fingerprint"]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path
    except OSError:
        log.warning("autotune: could not persist tuned.json for %r",
                    run_name, exc_info=True)
        return None


def _finish_report(run_name, session_id, command, trials, trial0,
                   metric=None):
    """Rank trials, crown the byte-identical winner, persist it, and
    build the doctor-schema-valid session report."""
    qualified = [t for t in trials
                 if t.get("byte_identical", True)
                 and isinstance(t.get("wall_seconds"), (int, float))]
    winner = min(qualified, key=lambda t: t["wall_seconds"]) \
        if qualified else trial0
    improvement = (trial0["wall_seconds"] / winner["wall_seconds"]
                   if winner.get("wall_seconds")
                   and trial0.get("wall_seconds") else 1.0)
    for t in trials:  # schema discipline: optionals omitted, not null
        for key in ("mbps", "digest"):
            if t.get(key) is None:
                t.pop(key, None)
        if t.get("wall_seconds") is None:  # required by the schema
            t["wall_seconds"] = t.get("cmd_seconds") or 0.0
    tuned_path = None
    if winner is not trial0:
        full = dict(winner.get("knobs") or {})
        if winner.get("n_partitions"):
            full["n_partitions"] = winner["n_partitions"]
        recs = _corpus(run_name)
        tuned_path = _persist_winner(
            run_name, session_id,
            {"knobs": full, "wall_seconds": winner.get("wall_seconds"),
             "mbps": winner.get("mbps"), "trial": winner.get("trial"),
             "fingerprint": (recs[-1].get("fingerprint")
                             if recs else None)})
    report = {
        "schema": SCHEMA,
        "run": run_name,
        "wall_seconds": winner.get("wall_seconds") or 0.0,
        "stages": [],
        "findings": [],
        "autotune": {
            "session": session_id,
            "command": command,
            "trials": trials,
            "winner": {k: v for k, v in (
                ("trial", winner.get("trial")),
                ("knobs", winner.get("knobs") or {}),
                ("wall_seconds", winner.get("wall_seconds")),
                ("mbps", winner.get("mbps")),
            ) if v is not None},
            "baseline_wall_seconds": trial0.get("wall_seconds") or 0.0,
            "improvement": round(improvement, 4),
            "byte_identical": all(t.get("byte_identical", True)
                                  for t in trials),
            "corpus_records": len(_corpus(run_name)),
        },
    }
    if tuned_path:
        report["autotune"]["tuned_path"] = tuned_path
    if metric:
        report["metric"] = metric
    if winner.get("mbps") is not None:
        report["value"] = winner["mbps"]
    return report


def session(command, run_name, trials=None, assert_dir=None,
            base_env=None, out=None):
    """One unattended autotune session over a subprocess command.

    Trial 0 runs ``command`` under the incoming environment; each
    further trial exports one candidate knob vector via env vars.
    Returns the session report dict (see :func:`_finish_report`)."""
    out = out or (lambda msg: print(msg, file=sys.stderr, flush=True))
    n_trials = max(2, trials if trials is not None
                   else settings.autotune_trials)
    session_id = "autotune-{}".format(int(time.time()))
    results = []
    baseline_digest = None
    metric = None

    def run_trial(idx, knobs, why):
        nonlocal baseline_digest, metric
        env = dict(base_env if base_env is not None else os.environ)
        env.update(as_env(knobs))
        if assert_dir and os.path.isdir(assert_dir):
            # The witness dir is the trial's output dir: stale part
            # files from the previous trial (a pipeline that does not
            # clear its own sink, or one writing fewer partitions this
            # trial) would poison the digest with phantom diffs.
            import shutil

            shutil.rmtree(assert_dir)
        before = {_record_key(r) for r in _corpus(run_name)}
        t0 = time.monotonic()
        proc = subprocess.run(command, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL)
        cmd_wall = time.monotonic() - t0
        new = _new_records(run_name, before)
        wall, mbps, n_parts = _trial_measurement(new, cmd_wall)
        if proc.stdout:
            # Bench convention: last stdout line is one JSON record.
            # Its headline value WINS over the corpus-record throughput
            # (input-MB/s vs output-bytes/s — the bench's own scale is
            # what baselines and TUNE_r*.json compare on); the corpus
            # stays the wall-clock source either way.
            try:
                doc = json.loads(
                    proc.stdout.decode("utf-8", "replace")
                    .strip().splitlines()[-1])
                metric = doc.get("metric") or metric
                if isinstance(doc.get("value"), (int, float)) \
                        and not isinstance(doc.get("value"), bool):
                    mbps = float(doc["value"])
            except (ValueError, IndexError, AttributeError):
                pass
        digest = dir_digest(assert_dir)
        trial = {
            "trial": idx, "knobs": knobs, "why": why,
            "wall_seconds": round(wall, 4) if wall is not None else None,
            "cmd_seconds": round(cmd_wall, 4),
            "mbps": mbps,
            "returncode": proc.returncode,
            "corpus_records_added": len(new),
        }
        if n_parts is not None:
            trial["n_partitions"] = n_parts
        if digest is not None:
            trial["digest"] = digest
            if idx == 0:
                baseline_digest = digest
            else:
                trial["byte_identical"] = digest == baseline_digest
        elif idx > 0 and baseline_digest is not None:
            # The baseline produced a witness and this trial did not
            # (the knob vector short-circuited the pipeline's output):
            # a trial with no output must never be crowned on its
            # near-zero wall.
            trial["byte_identical"] = False
        if proc.returncode != 0:
            trial["byte_identical"] = False
        results.append(trial)
        out("autotune trial {}: {} -> {}s{}{}".format(
            idx, knobs or "baseline config", trial["wall_seconds"],
            " ({} MB/s)".format(mbps) if mbps is not None else "",
            "" if trial.get("byte_identical", True)
            else "  DISQUALIFIED (output differs or nonzero exit)"))
        return trial

    trial0 = run_trial(0, {}, "baseline configuration")
    if trial0["returncode"] != 0:
        raise RuntimeError(
            "autotune: baseline trial exited {} — nothing to tune"
            .format(trial0["returncode"]))
    for i, cand in enumerate(candidate_vectors(run_name, n_trials - 1),
                             start=1):
        run_trial(i, cand["knobs"], cand["why"])
    report = _finish_report(run_name, session_id,
                            " ".join(command), results, trial0, metric)
    a = report["autotune"]
    out("autotune winner: trial {} ({}) {:.2f}x over baseline, "
        "byte_identical={}".format(
            a["winner"]["trial"], a["winner"]["knobs"] or "baseline",
            a["improvement"], a["byte_identical"]))
    return report


def tune_settings_session(measure, run_name, trials=None,
                          digest_of=None, out=None):
    """In-process autotune for benches (``settings.autotune``).

    ``measure()`` executes the pipeline once under the CURRENT settings
    and returns ``(wall_seconds, result)``; candidate vectors are
    applied where the port keeps each knob around each call
    (always restored).  ``digest_of(result)`` (optional) supplies the
    byte-exactness witness.  Returns ``(best_result, report)`` where
    ``best_result`` is the winning trial's ``measure()`` result."""
    from . import history

    out = out or (lambda msg: print(msg, file=sys.stderr, flush=True))
    n_trials = max(2, trials if trials is not None
                   else settings.autotune_trials)
    session_id = "autotune-inproc-{}".format(int(time.time()))
    results = []
    trial_results = {}
    baseline_digest = None

    def run_trial(idx, knobs, why):
        nonlocal baseline_digest
        homes = {k: history.knob_home(k) for k in knobs}
        saved = {k: getattr(*h) for k, h in homes.items() if h is not None}
        for k, v in knobs.items():
            if homes[k] is not None:
                setattr(homes[k][0], homes[k][1], v)
        try:
            before = {_record_key(r) for r in _corpus(run_name)}
            wall, result = measure()
            new = _new_records(run_name, before)
        finally:
            for k, v in saved.items():
                setattr(homes[k][0], homes[k][1], v)
        rec_wall, mbps, n_parts = _trial_measurement(new, wall)
        trial = {"trial": idx, "knobs": knobs, "why": why,
                 "wall_seconds": round(min(wall, rec_wall or wall), 4),
                 "mbps": mbps,
                 "corpus_records_added": len(new)}
        if n_parts is not None:
            trial["n_partitions"] = n_parts
        if digest_of is not None:
            digest = digest_of(result)
            if digest is not None:
                trial["digest"] = digest
            if idx == 0:
                baseline_digest = digest
            elif digest is not None:
                trial["byte_identical"] = digest == baseline_digest
            elif baseline_digest is not None:
                trial["byte_identical"] = False  # witness vanished
        results.append(trial)
        trial_results[idx] = result
        out("autotune trial {}: {} -> {}s".format(
            idx, knobs or "baseline config", trial["wall_seconds"]))
        return trial

    trial0 = run_trial(0, {}, "baseline configuration")
    for i, cand in enumerate(candidate_vectors(run_name, n_trials - 1),
                             start=1):
        run_trial(i, cand["knobs"], cand["why"])
    report = _finish_report(run_name, session_id, "<in-process>",
                            results, trial0)
    best = trial_results[report["autotune"]["winner"]["trial"]]
    return best, report


def main_autotune(args):
    """The doctor's ``--autotune`` (the argparse namespace of
    ``doctor.main``)."""
    command = list(args.runs or ())
    if not command:
        print("doctor: --autotune needs the pipeline command after the "
              "run name: doctor RUN --autotune -- CMD ...",
              file=sys.stderr)
        return 2
    try:
        report = session(command, args.run, trials=args.trials,
                         assert_dir=args.assert_dir)
    except RuntimeError as e:
        print("doctor: {}".format(e), file=sys.stderr)
        return 2
    text = json.dumps(report, indent=2, sort_keys=True)
    if args.report:
        with open(args.report, "w") as f:
            f.write(text + "\n")
        print("autotune report written to {}".format(args.report),
              file=sys.stderr)
    if getattr(args, "json", False) or not args.report:
        print(text)
    a = report["autotune"]
    # Exit discipline: 0 = tuned (or already optimal) with every trial
    # byte-identical; 4 = a trial produced different bytes (the winner
    # never crowns such a trial, but the operator must know).
    return 0 if a["byte_identical"] else 4
