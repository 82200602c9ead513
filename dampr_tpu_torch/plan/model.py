"""Learned per-operator throughput model over the run-history corpus.

Port of ``dampr_tpu/plan/model.py``, whole and pure stdlib: the same
features, fits, searches and reasons on the same records.

- **features** (:func:`stage_features`): one row per recorded stage:
  operator class (scanner / map / fold / merge / exchange / device /
  sink, from the stage-shape provenance and the recorded target), bytes
  in and out, record width, jobs, spill volume, measured seconds, and
  the record's knob snapshot.
- **fit** (:func:`fit`): per operator class, least squares
  ``seconds = secs_per_mb * MB + secs_per_job * jobs`` with one
  robustness pass (refit without large-residual outliers); a class takes
  part past ``settings.cost_model_min_points`` measurements.
- **search**: bounded candidates per knob (:data:`KNOB_BOUNDS`, never
  left), each scored by the fits, a change kept only past
  ``settings.cost_model_margin``; the knobs the per-stage fits cannot
  see are chosen from observed variance across runs of one fingerprint.
- **pricing**: :func:`price_handoff` weighs runs with the device handoff
  resident against lowered runs that spilled the edge, per input MB.

Everything lands in the plan report's ``cost`` section (rendered by
``explain()``).  ``settings.cost_model = "off"`` is the kill switch.
"""

import json
import logging
import os
import statistics

from .. import settings

log = logging.getLogger("dampr_tpu_torch.plan.model")

#: Operator classes the model fits separately.  ``scanner`` = native
#: byte-scanning maps (ops.text vocabulary), ``map`` = other host maps,
#: ``fold`` = host reduces, ``merge`` = sort/merge re-key maps,
#: ``exchange`` = mesh-routed redistributions, ``device`` = lowered
#: stages, ``sink`` = sinks.
OP_CLASSES = ("scanner", "map", "fold", "merge", "exchange", "device",
              "sink")

#: Native scanner op names (provenance via the stage shape string).
_SCANNER_OPS = ("TokenCounts", "DocFreq", "ParseNumbers")

#: Documented legal range per searchable knob — the single source of
#: truth the knob search clamps against (property-pinned: no proposal
#: ever leaves these bounds).  Discrete knobs list their legal values.
KNOB_BOUNDS = {
    "n_partitions": (1, 4096),
    "batch_size": (16, 1 << 20),
    "merge_fanin": (4, 4096),
    "overlap_windows": (0, 8),
    "spill_write_threads": (0, 8),
    "spill_read_prefetch": (0, 8),
    "exchange_hbm_budget": (1 << 20, 1 << 30),
    "exchange_chunk_bytes": (0, 1 << 30),
    "spill_codec": ("auto", "raw", "zlib", "gzip", "lz4", "zstd"),
    "shuffle_target": ("host", "mesh"),
}

#: The environment variable the port reads each knob from at import (the
#: vector an autotune session exports to its subprocess trials; a
#: choice's ``env`` names it).
ENV_OF = {
    "n_partitions": None,
    "batch_size": None,
    "merge_fanin": "DAMPR_TPU_TORCH_MERGE_FANIN",
    "overlap_windows": "DAMPR_TPU_TORCH_OVERLAP_WINDOWS",
    "spill_write_threads": "DAMPR_TPU_TORCH_SPILL_WRITERS",
    "spill_read_prefetch": "DAMPR_TPU_TORCH_SPILL_PREFETCH",
    "exchange_hbm_budget": "DAMPR_TPU_TORCH_EXCHANGE_HBM",
    "exchange_chunk_bytes": "DAMPR_TPU_TORCH_EXCHANGE_CHUNK",
    "spill_codec": "DAMPR_TPU_TORCH_SPILL_CODEC",
}

#: Run-level knobs whose effect the per-stage regressors cannot model:
#: chosen from observed corpus variance (same plan fingerprint, different
#: knob value -> measured throughput decides).
VARIANCE_KNOBS = ("overlap_windows", "spill_write_threads",
                  "spill_read_prefetch", "merge_fanin", "spill_codec",
                  "exchange_hbm_budget")


def in_bounds(knob, value):
    """Is ``value`` legal for ``knob`` per :data:`KNOB_BOUNDS`?"""
    bounds = KNOB_BOUNDS.get(knob)
    if bounds is None:
        return False
    if isinstance(bounds[0], str):
        return value in bounds
    lo, hi = bounds
    return (isinstance(value, (int, float))
            and not isinstance(value, bool) and lo <= value <= hi)


def clamp(knob, value):
    """``value`` forced inside ``knob``'s documented bounds."""
    bounds = KNOB_BOUNDS.get(knob)
    if bounds is None or isinstance(bounds[0], str):
        return value
    lo, hi = bounds
    return max(lo, min(hi, value))


def op_class(stage_rec, shape):
    """Operator class for one recorded stage (its provenance is the
    shape string the corpus match key already carries)."""
    target = stage_rec.get("target")
    if target == "device":
        return "device"
    kind = stage_rec.get("kind") or (shape.split(":", 1)[0]
                                     if shape else None)
    if kind == "reduce":
        if stage_rec.get("shuffle_target") == "mesh":
            return "exchange"
        return "fold"
    if kind == "sink":
        return "sink"
    if kind == "map":
        if any(op in (shape or "") for op in _SCANNER_OPS):
            return "scanner"
        if "Rekey" in (shape or "") and not (shape or "").endswith("+c"):
            # A combiner-less re-key chain is a sort_by materialization
            # (read back through the k-way merge); a combinered one is a
            # keyed map feeding a fold — a plain map for cost purposes.
            return "merge"
        if stage_rec.get("shuffle_target") == "mesh":
            return "exchange"
        return "map"
    return "map"


def stage_features(record):
    """Feature rows for one corpus record: one dict per recorded stage
    with measured IO, derived widths, the op class, and the run-level
    knob snapshot.  Tolerant by construction — missing fields become
    None/0, never a raise (legacy and corrupt-adjacent records degrade
    to thinner features; see tests)."""
    if not isinstance(record, dict):
        return []
    shapes = {s.get("sid"): s.get("shape")
              for s in record.get("stage_shapes") or ()
              if isinstance(s, dict)}
    knobs = record.get("settings") or {}
    rows = []
    for st in record.get("stages") or ():
        if not isinstance(st, dict):
            continue
        sid = st.get("stage")
        shape = shapes.get(sid)
        bytes_in = st.get("bytes_in") or 0
        bytes_out = st.get("bytes_out") or 0
        recs_out = st.get("records_out") or 0
        seconds = st.get("seconds")
        if not isinstance(seconds, (int, float)) or seconds < 0:
            continue
        rows.append({
            "run": record.get("run"),
            "sid": sid,
            "shape": shape,
            "op_class": op_class(st, shape),
            "bytes_in": bytes_in,
            "bytes_out": bytes_out,
            "mb": max(bytes_in, bytes_out) / 1e6,
            "record_bytes": (bytes_out / float(recs_out)
                             if recs_out else None),
            "records_in": st.get("records_in") or 0,
            "records_out": recs_out,
            "jobs": st.get("jobs") or 1,
            "spill_bytes": st.get("spill_bytes") or 0,
            "seconds": float(seconds),
            "n_partitions": record.get("n_partitions"),
            "knobs": knobs,
        })
    return rows


def features(records):
    """Flat feature rows over a record list.  Rank-tagged records
    (non-zero ranks of a fleet run) are excluded — their rank-local
    timings would weight one run once per rank."""
    rows = []
    for rec in records or ():
        if isinstance(rec, dict) and rec.get("rank"):
            continue
        rows.extend(stage_features(rec))
    return rows


class ClassFit(object):
    """One operator class's regressor: seconds = secs_per_mb * MB +
    secs_per_job * jobs (both clamped non-negative)."""

    def __init__(self, op_cls, secs_per_mb, secs_per_job, points, r2):
        self.op_class = op_cls
        self.secs_per_mb = secs_per_mb
        self.secs_per_job = secs_per_job
        self.points = points
        self.r2 = r2

    def predict(self, mb, jobs=1):
        return max(0.0, self.secs_per_mb * max(0.0, mb)
                   + self.secs_per_job * max(0, jobs))

    def mbps(self):
        """Modeled marginal throughput (MB/s), None for fixed-cost-only
        fits."""
        if self.secs_per_mb <= 0:
            return None
        return 1.0 / self.secs_per_mb

    def to_dict(self):
        return {
            "op_class": self.op_class,
            "secs_per_mb": round(self.secs_per_mb, 6),
            "secs_per_job": round(self.secs_per_job, 6),
            "mbps": (round(self.mbps(), 3)
                     if self.mbps() is not None else None),
            "points": self.points,
            "r2": round(self.r2, 4),
        }


def _lstsq2(points):
    """Least squares for seconds = b*mb + g*jobs over (mb, jobs, secs)
    triples (closed-form 2x2 normal equations, no intercept — a stage
    over zero bytes with zero jobs takes zero time).  Falls back to the
    single-feature slope when the system is singular or a coefficient
    goes negative.  Returns (b, g)."""
    sxx = sxy = syy = sxs = sys_ = 0.0
    for mb, jobs, secs in points:
        sxx += mb * mb
        sxy += mb * jobs
        syy += jobs * jobs
        sxs += mb * secs
        sys_ += jobs * secs
    det = sxx * syy - sxy * sxy
    if abs(det) > 1e-12:
        b = (sxs * syy - sys_ * sxy) / det
        g = (sys_ * sxx - sxs * sxy) / det
        if b >= 0 and g >= 0:
            return b, g
    # Degenerate or sign-flipped: one-feature fits, best SSE wins.
    b1 = (sxs / sxx) if sxx > 0 else 0.0
    g1 = (sys_ / syy) if syy > 0 else 0.0
    sse_b = sum((secs - b1 * mb) ** 2 for mb, _j, secs in points)
    sse_g = sum((secs - g1 * jobs) ** 2 for _m, jobs, secs in points)
    if b1 > 0 and (g1 <= 0 or sse_b <= sse_g):
        return max(0.0, b1), 0.0
    return 0.0, max(0.0, g1)


def _fit_class(op_cls, rows):
    points = [(r["mb"], r["jobs"], r["seconds"]) for r in rows]
    if len(points) < max(2, settings.cost_model_min_points):
        return None
    b, g = _lstsq2(points)
    # One robustness pass: drop large-residual outliers, refit (a cold
    # first run or a noisy-neighbor spike must not own the slope).
    resid = [abs(secs - (b * mb + g * jobs)) for mb, jobs, secs in points]
    med = statistics.median(resid)
    if med > 0:
        kept = [p for p, r in zip(points, resid) if r <= 3.0 * med]
        if len(kept) >= max(2, settings.cost_model_min_points):
            points = kept
            b, g = _lstsq2(points)
    mean_s = sum(p[2] for p in points) / len(points)
    sst = sum((p[2] - mean_s) ** 2 for p in points)
    sse = sum((secs - (b * mb + g * jobs)) ** 2
              for mb, jobs, secs in points)
    r2 = 1.0 - (sse / sst) if sst > 0 else (1.0 if sse < 1e-9 else 0.0)
    return ClassFit(op_cls, b, g, len(points), r2)


class CostModel(object):
    """Per-operator-class fits + per-knob observed-variance tables."""

    def __init__(self, fits, knob_obs, n_records):
        self.fits = fits            # {op_class: ClassFit}
        self.knob_obs = knob_obs    # {knob: {value_repr: [mbps,...]}}
        self.n_records = n_records

    def fit_for(self, op_cls):
        return self.fits.get(op_cls)

    def predict_stage(self, op_cls, mb, jobs=1):
        f = self.fits.get(op_cls)
        return f.predict(mb, jobs) if f is not None else None

    def confident_for(self, op_classes):
        """(ok, reason): can the model price a plan whose stages span
        ``op_classes``?  Every class present must be fit."""
        missing = sorted(c for c in set(op_classes) if c not in self.fits)
        if not self.fits:
            return False, "thin-corpus ({} record(s) yield no fit; " \
                "floor is {} per class)".format(
                    self.n_records, settings.cost_model_min_points)
        if missing:
            return False, "unfit operator class(es): {} (< {} " \
                "measurements)".format(
                    ", ".join(missing), settings.cost_model_min_points)
        return True, None

    def shuffle_prediction(self, mb):
        """See module-level :func:`shuffle_prediction`."""
        return shuffle_prediction(self, mb)

    def to_dict(self):
        return {
            "records": self.n_records,
            "classes": {c: f.to_dict()
                        for c, f in sorted(self.fits.items())},
        }


def _knob_value_key(v):
    return json.dumps(v, sort_keys=True, default=str)


def _knob_observations(records, fingerprint):
    """{knob: {value_key: {"value": v, "mbps": [..]}}} over records of
    one plan fingerprint — run-level measured throughput grouped by the
    knob value the run executed under."""
    out = {k: {} for k in VARIANCE_KNOBS}
    for rec in records or ():
        if not isinstance(rec, dict) or rec.get("rank"):
            continue
        if fingerprint and rec.get("fingerprint") != fingerprint:
            continue
        mbps = ((rec.get("throughput") or {}).get("mbps"))
        if not isinstance(mbps, (int, float)) or mbps <= 0:
            continue
        knobs = rec.get("settings") or {}
        for knob in VARIANCE_KNOBS:
            if knob not in knobs:
                continue
            cell = out[knob].setdefault(
                _knob_value_key(knobs[knob]),
                {"value": knobs[knob], "mbps": []})
            cell["mbps"].append(float(mbps))
    return out


def build(records, fingerprint=None):
    """Fit a :class:`CostModel` from corpus records (rank-tagged records
    excluded).  ``fingerprint`` scopes the knob-variance tables to one
    plan shape — cross-shape throughput is not comparable."""
    rows = features(records)
    by_class = {}
    for r in rows:
        by_class.setdefault(r["op_class"], []).append(r)
    fits = {}
    for op_cls, cls_rows in by_class.items():
        f = _fit_class(op_cls, cls_rows)
        if f is not None:
            fits[op_cls] = f
    n = sum(1 for r in records or ()
            if isinstance(r, dict) and not r.get("rank"))
    return CostModel(fits, _knob_observations(records, fingerprint), n)


def _pow2_candidates(lo, hi):
    out = []
    v = 1
    while v <= hi:
        if v >= lo:
            out.append(v)
        v *= 2
    return out


def search_partitions(model, hist_stages, n_now):
    """Model-searched partition count: predicted run seconds over the
    plan's fold/exchange stages as a function of P (their job count
    tracks P; byte volume does not), minimized over bounded power-of-two
    candidates.  Returns (choice dict or None)."""
    targets = [st for st in hist_stages
               if st.get("op_class") in ("fold", "exchange")
               and st.get("mb") is not None]
    if not targets:
        return None
    lo, hi = KNOB_BOUNDS["n_partitions"]
    cands = _pow2_candidates(max(lo, 4),
                             min(hi, max(4 * settings.partitions, n_now)))
    if n_now not in cands:
        cands.append(n_now)

    def predicted(P):
        total = 0.0
        for st in targets:
            sec = model.predict_stage(st["op_class"], st["mb"], P)
            if sec is None:
                return None
            total += sec
        return total

    static_s = predicted(n_now)
    if static_s is None:
        return None
    best, best_s = n_now, static_s
    for P in cands:
        s = predicted(P)
        if s is not None and s < best_s:
            best, best_s = P, s
    if best == n_now or static_s <= 0:
        return None
    if (static_s - best_s) / static_s < settings.cost_model_margin:
        return None
    return {
        "knob": "n_partitions",
        "static": n_now,
        "chosen": int(clamp("n_partitions", best)),
        "predicted_seconds": round(best_s, 4),
        "static_seconds": round(static_s, 4),
        "reason": "argmin of modeled fold/exchange seconds over {} "
                  "candidate partition counts (secs_per_job prices the "
                  "per-partition fixed cost)".format(len(cands)),
    }


def search_variance_knobs(model, current):
    """Observed-variance choices for the run-level knobs the per-stage
    regressors cannot see.  ``current`` maps knob -> this run's value.
    Returns a list of choice dicts; knobs without variance (or without
    enough measured gain) contribute a no-change entry with the reason
    recorded — the honest 'measure me' signal the autotune loop acts
    on."""
    choices = []
    for knob in VARIANCE_KNOBS:
        obs = model.knob_obs.get(knob) or {}
        cur = current.get(knob)
        if len(obs) < 2:
            choices.append({
                "knob": knob, "static": cur, "chosen": cur,
                "reason": ("no-variance: corpus holds {} distinct "
                           "value(s) — autotune a trial to measure "
                           "another".format(len(obs)))})
            continue
        scored = sorted(
            ((statistics.median(cell["mbps"]), cell["value"])
             for cell in obs.values()),
            key=lambda t: -t[0])
        best_mbps, best_val = scored[0]
        cur_cell = obs.get(_knob_value_key(cur))
        cur_mbps = (statistics.median(cur_cell["mbps"])
                    if cur_cell else None)
        if best_val == cur or not in_bounds(knob, best_val):
            choices.append({
                "knob": knob, "static": cur, "chosen": cur,
                "reason": "current value measured best over {} "
                          "observed value(s)".format(len(obs))})
            continue
        if (cur_mbps is not None and cur_mbps > 0
                and (best_mbps - cur_mbps) / cur_mbps
                < settings.cost_model_margin):
            choices.append({
                "knob": knob, "static": cur, "chosen": cur,
                "reason": "observed gain under the {:.0%} margin".format(
                    settings.cost_model_margin)})
            continue
        choice = {
            "knob": knob, "static": cur, "chosen": best_val,
            "measured_mbps": round(best_mbps, 3),
            "reason": "measured {} MB/s at {!r} vs {} at the current "
                      "{!r} over {} corpus value(s)".format(
                          round(best_mbps, 2), best_val,
                          round(cur_mbps, 2) if cur_mbps else "?",
                          cur, len(obs)),
        }
        if ENV_OF.get(knob):
            choice["env"] = ENV_OF[knob]
        choices.append(choice)
    return choices


def predict_plan(model, hist_stages, n_partitions):
    """Modeled wall for a plan whose per-stage history rows are
    ``hist_stages``: sum of per-stage predictions (fold/exchange job
    counts track the partition count).  None when any class is unfit."""
    total = 0.0
    for st in hist_stages:
        jobs = (n_partitions if st.get("op_class") in ("fold", "exchange")
                else st.get("jobs") or 1)
        sec = model.predict_stage(st["op_class"], st.get("mb") or 0.0,
                                  jobs)
        if sec is None:
            return None
        total += sec
    return total


def _run_secs_per_mb(rec):
    """Wall seconds per input megabyte for one corpus record, or None.
    Input volume is the largest stage ``bytes_in`` (the corpus scan) —
    normalizing lets differently-sized runs of the same plan shape
    price one edge."""
    wall = rec.get("wall_seconds")
    if not wall or wall <= 0:
        return None
    mb = max((float(st.get("bytes_in") or 0)
              for st in rec.get("stages") or ()), default=0.0) / 1e6
    if mb <= 0:
        return None
    return float(wall) / mb


def price_handoff(records, fingerprint):
    """Observed handoff-vs-spill pricing for one plan fingerprint: BEST
    wall seconds PER INPUT MB of corpus runs whose plan carried
    device-handoff edges vs LOWERED runs that spilled the same edges.
    Only lowered runs qualify on either side — a host-codec run never
    had the edge to decide, so its wall says nothing about handoff-vs-
    spill — and only the most recent ``settings.history_window`` records
    per side vote, so stale configurations age out.  The comparison is
    each side's MINIMUM: recorded walls include one-time jit compiles
    (every cold process re-pays them) and box-load noise, both of which
    only ever inflate a wall, so the best observed run is the honest
    steady-state estimate — a median would let one side's cold-compile
    records outvote the other side's warm ones.  Returns (decision,
    reason) — decision ``"device"``/``"spill"``, or None when the corpus
    lacks variance (auto then defaults to the handoff; the reason is the
    honest 'measure me' signal the autotune loop acts on)."""
    on, off = [], []
    for rec in records:
        if not isinstance(rec, dict) or rec.get("rank"):
            continue
        if rec.get("fingerprint") != fingerprint:
            continue
        if not rec.get("device_fraction"):
            continue  # host-path run: the edge never existed
        spm = _run_secs_per_mb(rec)
        if spm is None:
            continue
        h = rec.get("handoff") or {}
        if h.get("edges") and not h.get("degrades"):
            on.append(spm)
        elif not h.get("edges"):
            off.append(spm)
        # degraded handoff runs vote on neither side: their wall mixes
        # both paths
    win = max(1, int(getattr(settings, "history_window", 8)))
    on, off = on[-win:], off[-win:]
    if not on or not off:
        return None, ("no handoff-vs-spill variance among lowered runs "
                      "({} with the edge resident, {} without)"
                      .format(len(on), len(off)))
    mon = min(on)
    moff = min(off)
    if mon > moff * (1.0 + max(0.0, settings.cost_model_margin)):
        return "spill", ("corpus prices the spill path faster "
                         "({:.3f} vs {:.3f} s/MB best-of over {}+{} "
                         "lowered runs) — edge declined".format(
                             moff, mon, len(off), len(on)))
    return "device", ("corpus prices the resident edge faster "
                      "({:.3f} vs {:.3f} s/MB best-of over {}+{} lowered "
                      "runs)".format(mon, moff, len(on), len(off)))


def shuffle_prediction(model, mb):
    """(target, reason) from modeled exchange-vs-fold throughput for one
    redistribution of ``mb`` megabytes, or None when either class is
    unfit — the caller then falls back to the byte-floor heuristic."""
    ex = model.fit_for("exchange")
    fold = model.fit_for("fold")
    if ex is None or fold is None:
        return None
    ex_s = ex.predict(mb, 1)
    host_s = fold.predict(mb, 1)
    if ex_s <= 0 or host_s <= 0:
        return None
    if ex_s * (1.0 + settings.cost_model_margin) < host_s:
        return "mesh", ("model: exchange predicts {:.3f}s vs {:.3f}s on "
                        "the host fold path for {:.1f} MB".format(
                            ex_s, host_s, mb))
    return "host", ("model: host fold predicts {:.3f}s vs {:.3f}s over "
                    "the mesh exchange for {:.1f} MB".format(
                        host_s, ex_s, mb))


# ---------------------------------------------------------------------------
# Checked-in trajectory feedstock (BENCH/SHUFFLE/MULTICHIP/SKEW/TUNE JSONs)
# ---------------------------------------------------------------------------

def load_trajectory(paths):
    """Coarse run-level records from the checked-in bench trajectory
    files (BENCH_r*.json / SHUFFLE_r*.json / SKEW_r*.json / TUNE_r*.json;
    a record's ``parsed`` wrapper unwrapped).  Each yields
    ``{"metric", "mbps", "knobs": {...}}`` — feedstock for the autotune
    loop's knob priors, NOT per-stage fits (the trajectory has no
    per-stage telemetry).  Unreadable files are skipped, never fatal."""
    out = []
    for path in paths or ():
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
            doc = doc["parsed"]
        if not isinstance(doc, dict):
            continue
        if isinstance(doc.get("autotune"), dict):
            win = doc["autotune"].get("winner") or {}
            out.append({
                "metric": doc.get("metric") or "autotune",
                "mbps": win.get("mbps"),
                "knobs": win.get("knobs") or {},
                "source": os.path.basename(path),
            })
            continue
        value = doc.get("value")
        if not isinstance(value, (int, float)):
            continue
        knobs = {k: doc[k] for k in ("overlap_windows",)
                 if k in doc}
        out.append({"metric": doc.get("metric"), "mbps": float(value),
                    "knobs": knobs, "source": os.path.basename(path)})
    return out


def empty_section(enabled, reason=None, source="median"):
    sec = {"enabled": enabled, "source": source, "choices": [],
           "model": None}
    if reason:
        sec["reason"] = reason
    return sec
