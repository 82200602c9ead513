"""The learned cost model of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_cost_model.py``'s ``TestFeatureExtraction``,
``TestFit``, ``TestSearchBounds``, ``TestKillSwitchAndDegradation`` and
``TestTrajectoryFeedstock``.  Every model output is also held against the
JAX function's on the same records: fits to 1e-12 relative, choices and
reasons exactly.  Added: ``price_handoff`` on corpora that favour each
side, ``shuffle_choice`` (no caller in the port until the multi-card
slice), and ``load_tuned`` with the cost layer's use of it, fed a
hand-written ``tuned.json``.

Not ported: ``TestSearchBounds.test_candidate_vectors_stay_in_bounds``,
``TestAutotuneSession`` and ``TestCheckBenchSatellites`` (the autotune
session, ``doctor`` and ``check_bench`` are a later slice).
"""

import json
import operator
import os
import random
import types

import pytest

from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import history as ref_history
from dampr_tpu.plan import cost as ref_cost
from dampr_tpu.plan import model as ref_model
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.obs import history
from dampr_tpu_torch.plan import cost, model

REL = 1e-12


@pytest.fixture
def isolated(tmp_path):
    """One scratch root (the corpus lives under it) for both packages, the
    model on, the port on the CPU."""
    old = (settings.scratch_root, settings.cost_model, settings.device,
           ref_settings.scratch_root, ref_settings.cost_model)
    settings.scratch_root = ref_settings.scratch_root = str(
        tmp_path / "scratch")
    settings.cost_model = ref_settings.cost_model = "auto"
    settings.device = "cpu"
    yield tmp_path
    (settings.scratch_root, settings.cost_model, settings.device,
     ref_settings.scratch_root, ref_settings.cost_model) = old


def _record(run="r", stages=None, mbps=10.0, knobs=None, rank=None,
            wall=1.0, schema=history.SCHEMA, fingerprint="fp0",
            shapes=None):
    rec = {
        "schema": schema,
        "run": run,
        "wall_seconds": wall,
        "n_partitions": 64,
        "stage_shapes": shapes if shapes is not None else [
            {"sid": 1, "shape": "map:DocFreq+c"},
            {"sid": 2, "shape": "reduce:AssocFoldReducer"},
        ],
        "stages": stages if stages is not None else [
            {"stage": 1, "kind": "map", "target": "host", "jobs": 4,
             "records_in": 1000, "records_out": 900,
             "bytes_in": 8_000_000, "bytes_out": 6_000_000,
             "spill_bytes": 0, "seconds": 0.8},
            {"stage": 2, "kind": "reduce", "target": "host",
             "shuffle_target": "host", "jobs": 64, "records_in": 900,
             "records_out": 50, "bytes_in": 6_000_000,
             "bytes_out": 4_000, "spill_bytes": 0, "seconds": 0.2},
        ],
        "throughput": {"records_out": 50, "bytes_out": 4_000,
                       "mbps": mbps},
        "settings": dict({"overlap_windows": 2, "spill_write_threads": 2,
                          "spill_read_prefetch": 2, "merge_fanin": 512,
                          "spill_codec": "auto",
                          "exchange_hbm_budget": 64 * 1024 ** 2},
                         **(knobs or {})),
        "fingerprint": fingerprint,
    }
    if rank is not None:
        rec["rank"] = rank
    return rec


def _same_model(m, rm):
    """The port's CostModel equals the JAX one: classes, points, and
    coefficients and r2 to 1e-12 relative."""
    assert m.n_records == rm.n_records
    assert sorted(m.fits) == sorted(rm.fits)
    for cls, f in m.fits.items():
        rf = rm.fits[cls]
        assert f.points == rf.points
        for attr in ("secs_per_mb", "secs_per_job", "r2"):
            assert getattr(f, attr) == pytest.approx(getattr(rf, attr),
                                                     rel=REL, abs=1e-300)
    assert m.knob_obs == rm.knob_obs
    assert m.to_dict() == rm.to_dict()


class TestFeatureExtraction:
    def test_clean_record_rows(self):
        rows = model.stage_features(_record())
        assert rows == ref_model.stage_features(_record())
        assert len(rows) == 2
        scan, fold = rows
        assert scan["op_class"] == "scanner"  # DocFreq provenance
        assert fold["op_class"] == "fold"
        assert scan["mb"] == pytest.approx(8.0)
        assert fold["jobs"] == 64
        assert scan["record_bytes"] == pytest.approx(6_000_000 / 900)

    @pytest.mark.parametrize("rec, shape, want", [
        ({"kind": "map"}, "map:DocFreq+c", "scanner"),
        ({"kind": "map"}, "map:Rekey", "merge"),
        ({"kind": "map"}, "map:GMap.Rekey+c", "map"),
        ({"kind": "reduce", "shuffle_target": "mesh"}, "reduce:X",
         "exchange"),
        ({"kind": "reduce"}, "reduce:X", "fold"),
        ({"kind": "sink"}, "sink:TSV", "sink"),
        ({"kind": "map", "target": "device"}, "map:DocFreq+c", "device"),
        ({"kind": "map-chained"}, "map:ValueMap", "map"),
        ({}, None, "map"),
    ])
    def test_op_class_matrix(self, rec, shape, want):
        assert model.op_class(rec, shape) == want
        assert ref_model.op_class(rec, shape) == want

    def test_rank_tagged_records_excluded(self):
        recs = [_record(), _record(rank=1), _record(rank=2)]
        rows = model.features(recs)
        assert len(rows) == 2  # only the run-level record's stages
        assert rows == ref_model.features(recs)

    def test_corrupt_and_partial_records_degrade(self):
        assert model.stage_features(None) == []
        assert model.stage_features({"stages": "not-a-list"}) == []
        rec = {"stages": [
            {"stage": 0, "kind": "map", "seconds": "NaN-ish"},
            {"stage": 1, "kind": "map", "seconds": 0.5},
            "garbage",
        ]}
        rows = model.stage_features(rec)
        assert len(rows) == 1 and rows[0]["seconds"] == 0.5
        assert rows == ref_model.stage_features(rec)

    def test_legacy_v1_lines_upgrade_on_load(self, isolated):
        """A v1 corpus (no shuffle_target, no v field) loads, upgrades in
        memory and feeds the model, in both packages alike."""
        path = history.corpus_path("legacy")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        v1 = _record(schema="dampr-tpu-history/1")
        for st in v1["stages"]:
            st.pop("shuffle_target", None)
        with open(path, "w") as f:
            f.write(json.dumps(v1) + "\n")
            f.write("not json at all\n")
            f.write(json.dumps({"schema": "other/9", "stages": []}) + "\n")
            f.write(json.dumps({"schema": "dampr-tpu-history/99",
                                "stages": []}) + "\n")
            f.write(json.dumps(_record(rank=1)) + "\n")
        recs = history.load("legacy")
        assert recs == ref_history.load("legacy")
        assert len(recs) == 2
        up = recs[0]
        assert up["v"] == 1
        assert all(st.get("shuffle_target") is None
                   for st in up["stages"])
        rows = model.features(recs)
        assert len(rows) == 2
        assert {r["op_class"] for r in rows} == {"scanner", "fold"}

    def test_schema_version(self):
        cases = [{"schema": history.SCHEMA},
                 {"schema": "dampr-tpu-history/1"},
                 {"schema": "dampr-tpu-history/99"},
                 {"schema": "bogus"}, {}]
        got = [history.schema_version(c) for c in cases]
        assert got == [history.SCHEMA_VERSION, 1, None, None, None]
        assert got == [ref_history.schema_version(c) for c in cases]


class TestFit:
    def _slope_records(self, seed):
        recs = []
        rng = random.Random(seed)
        for _ in range(8):
            mb = 2.0 + 4.0 * rng.random()
            jobs = rng.choice([4, 16, 64])
            secs = 0.1 * mb + 0.002 * jobs
            recs.append(_record(stages=[
                {"stage": 2, "kind": "reduce", "target": "host",
                 "jobs": jobs, "bytes_in": int(mb * 1e6), "bytes_out": 10,
                 "records_in": 100, "records_out": 10,
                 "spill_bytes": 0, "seconds": secs}]))
        return recs

    @pytest.mark.parametrize("seed", [7, 8, 9])
    def test_recovers_slope_and_job_cost(self, seed):
        recs = self._slope_records(seed)
        m = model.build(recs)
        _same_model(m, ref_model.build(recs))
        f = m.fit_for("fold")
        assert f is not None
        assert f.secs_per_mb == pytest.approx(0.1, rel=0.05)
        assert f.secs_per_job == pytest.approx(0.002, rel=0.05)
        assert f.r2 > 0.95
        assert f.predict(10, 64) == pytest.approx(1.0 + 0.128, rel=0.1)
        assert f.predict(10, 64) == pytest.approx(
            ref_model.build(recs).fit_for("fold").predict(10, 64), rel=REL)

    def test_outlier_robustness(self):
        pts = [(mb, 1, 0.5 * mb) for mb in (1, 2, 3, 4, 5)]
        pts.append((3.0, 1, 50.0))  # cold-run spike
        recs = [_record(stages=[
            {"stage": 2, "kind": "reduce", "jobs": j,
             "bytes_in": int(mb * 1e6), "bytes_out": 1, "records_in": 1,
             "records_out": 1, "spill_bytes": 0, "seconds": s}])
            for mb, j, s in pts]
        m = model.build(recs)
        _same_model(m, ref_model.build(recs))
        assert m.fit_for("fold").secs_per_mb == pytest.approx(0.5, rel=0.1)

    def test_below_min_points_no_fit(self):
        recs = [_record() for _ in range(2)]
        m = model.build(recs)
        _same_model(m, ref_model.build(recs))
        assert m.fit_for("scanner") is None
        ok, why = m.confident_for(["scanner"])
        assert not ok and ("scanner" in why or "thin-corpus" in why)
        assert (ok, why) == ref_model.build(recs).confident_for(["scanner"])

    def test_confident_reports_missing_classes(self):
        recs = [_record() for _ in range(4)]
        m, rm = model.build(recs), ref_model.build(recs)
        _same_model(m, rm)
        for classes in (["scanner", "fold", "exchange"],
                        ["scanner", "fold"]):
            assert m.confident_for(classes) == rm.confident_for(classes)
        ok, why = m.confident_for(["scanner", "fold", "exchange"])
        assert not ok and "exchange" in why
        ok, why = m.confident_for(["scanner", "fold"])
        assert ok and why is None

    @pytest.mark.parametrize("seed", range(6))
    def test_random_corpora_fit_alike(self, seed):
        recs = TestSearchBounds()._random_records(random.Random(seed), 9)
        _same_model(model.build(recs, "fp0"), ref_model.build(recs, "fp0"))


class TestSearchBounds:
    """No search path proposes a value outside KNOB_BOUNDS, whatever the
    corpus says, and every proposal is the JAX package's."""

    def _random_records(self, rng, n):
        recs = []
        for _ in range(n):
            stages = []
            for sid, kind in ((1, "map"), (2, "reduce")):
                stages.append({
                    "stage": sid, "kind": kind,
                    "target": rng.choice(["host", "host", "device"]),
                    "shuffle_target": rng.choice([None, "host", "mesh"]),
                    "jobs": rng.choice([1, 4, 64, 256]),
                    "bytes_in": rng.randrange(0, 1 << 31),
                    "bytes_out": rng.randrange(0, 1 << 31),
                    "records_in": rng.randrange(0, 1 << 20),
                    "records_out": rng.randrange(0, 1 << 20),
                    "spill_bytes": 0,
                    "seconds": rng.random() * 100,
                })
            recs.append(_record(
                stages=stages, mbps=rng.random() * 500,
                knobs={
                    "overlap_windows": rng.choice([0, 2, 4, 8]),
                    "spill_write_threads": rng.choice([0, 2, 8]),
                    "merge_fanin": rng.choice([4, 64, 512, 4096]),
                    "spill_codec": rng.choice(["auto", "zstd", "zlib"]),
                    "exchange_hbm_budget": rng.choice(
                        [1 << 20, 1 << 26, 1 << 30]),
                }))
        return recs

    def test_partition_search_stays_in_bounds(self):
        rng = random.Random(1234)
        empty = types.SimpleNamespace(stages=[])
        for _ in range(40):
            recs = self._random_records(rng, rng.randrange(3, 9))
            m, rm = model.build(recs), ref_model.build(recs)
            rows = cost._hist_stage_rows({"stages": recs[-1]["stages"]},
                                         empty)
            assert rows == ref_cost._hist_stage_rows(
                {"stages": recs[-1]["stages"]}, empty)
            for r in rows:
                r["op_class"] = model.op_class(r, None)
            n_now = rng.choice([4, 64, 256])
            ch = model.search_partitions(m, rows, n_now)
            assert ch == ref_model.search_partitions(rm, rows, n_now)
            assert model.predict_plan(m, rows, n_now) == \
                ref_model.predict_plan(rm, rows, n_now)
            if ch is not None:
                lo, hi = model.KNOB_BOUNDS["n_partitions"]
                assert lo <= ch["chosen"] <= hi, ch
                assert ch["chosen"] != ch["static"]

    def test_variance_search_stays_in_bounds(self):
        rng = random.Random(99)
        current = {k: history.knob_value(k) for k in model.VARIANCE_KNOBS}
        for _ in range(40):
            recs = self._random_records(rng, rng.randrange(2, 10))
            m = model.build(recs, fingerprint="fp0")
            got = model.search_variance_knobs(m, current)
            want = ref_model.search_variance_knobs(
                ref_model.build(recs, fingerprint="fp0"), current)
            # each choice names the variable the port reads the knob from
            # (none for the exchange knobs, which wait for a mesh)
            for ch in want:
                if ch.pop("env", None) and model.ENV_OF.get(ch["knob"]):
                    ch["env"] = model.ENV_OF[ch["knob"]]
            assert got == want
            for ch in got:
                if ch["chosen"] == ch["static"]:
                    continue
                assert model.in_bounds(ch["knob"], ch["chosen"]), ch

    def test_clamp_and_in_bounds(self):
        for mod in (model, ref_model):
            assert mod.clamp("merge_fanin", 1 << 30) == 4096
            assert mod.clamp("overlap_windows", -3) == 0
            assert mod.in_bounds("spill_codec", "zstd")
            assert not mod.in_bounds("spill_codec", "brotli")
            assert not mod.in_bounds("n_partitions", True)
            assert not mod.in_bounds("nonexistent_knob", 1)
        assert model.KNOB_BOUNDS == ref_model.KNOB_BOUNDS
        assert model.VARIANCE_KNOBS == ref_model.VARIANCE_KNOBS

    def test_shuffle_prediction_agrees(self):
        rng = random.Random(3)
        for _ in range(20):
            recs = self._random_records(rng, rng.randrange(3, 12))
            m, rm = model.build(recs), ref_model.build(recs)
            for mb in (0.5, 8.0, 700.0):
                assert m.shuffle_prediction(mb) == rm.shuffle_prediction(mb)


def _fold_pipeline():
    return (Dampr.memory([(i % 50, 1) for i in range(30000)])
            .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))


def _run(name):
    em = _fold_pipeline().run(name)
    s = em.stats()
    em.delete()
    return s


class TestKillSwitchAndDegradation:
    def test_kill_switch_reproduces_median_path(self, isolated):
        """``settings.cost_model = "0"``: the adaptive decisions are the
        median path's, the kill switch is recorded and nothing is
        model-applied."""
        settings.cost_model = "0"
        for _ in range(4):
            s = _run("kill-switch")
        plan = s["plan"]
        assert plan["cost"]["enabled"] is False
        assert "disabled" in plan["cost"]["reason"]
        assert plan["cost"]["choices"] == []
        recs = history.load("kill-switch")
        matched = history.matching(recs, recs[-1]["stage_shapes"])
        hist = history.synthesize(
            matched[-max(1, settings.history_window):])
        reduce_bytes = max(st.get("bytes_in") or 0
                           for st in hist["stages"]
                           if st["kind"] == "reduce")
        want = cost._clamped_partitions(reduce_bytes)
        changes = {c["what"]: c for c in plan["adaptive"]["changes"]}
        assert changes["n_partitions"]["to"] == want
        assert s["n_partitions"] == want

    def test_kill_switch_apply_model_touches_nothing(self, isolated):
        for mod, st in ((cost, settings), (ref_cost, ref_settings)):
            st.cost_model = "off"
            runner = types.SimpleNamespace(
                graph=None, name="whatever", n_partitions=64,
                _explicit_partitions=False, resume=False)
            report = {}
            mod.apply_model(runner, types.SimpleNamespace(stages=[]),
                            report)
            assert report["cost"]["enabled"] is False
            assert report["cost"]["choices"] == []
            assert runner.n_partitions == 64

    def test_empty_corpus_degrades_to_static_with_reason(self, isolated):
        s = _run("cold-start")
        c = s["plan"]["cost"]
        assert c["enabled"] is False
        assert c["source"] == "static"
        assert "no-history" in c["reason"]

    def test_thin_corpus_degrades_to_median_with_reason(self, isolated):
        _run("thin")
        s = _run("thin")  # the corpus holds 1 record at adapt time
        c = s["plan"]["cost"]
        assert c["enabled"] is False
        assert c["source"] == "median-fallback"
        assert "thin-corpus" in c["reason"] or "unfit" in c["reason"]
        assert s["plan"]["adaptive"]["applied"] is True

    def test_confident_corpus_engages_model(self, isolated):
        for _ in range(4):
            s = _run("warm")
        c = s["plan"]["cost"]
        assert c["enabled"] is True
        assert c["source"] == "model"
        assert c["model"]["classes"]
        assert isinstance(c["choices"], list)
        untouched = [ch for ch in c["choices"]
                     if ch["chosen"] == ch["static"]]
        assert any("no-variance" in (ch.get("reason") or "")
                   for ch in untouched)


class TestTrajectoryFeedstock:
    def test_load_trajectory_mixed(self, tmp_path):
        (tmp_path / "BENCH_r01.json").write_text(json.dumps({
            "parsed": {"metric": "tfidf", "value": 100.0,
                       "overlap_windows": 2}}))
        (tmp_path / "TUNE_r01.json").write_text(json.dumps({
            "metric": "tfidf",
            "autotune": {"winner": {"mbps": 140.0,
                                    "knobs": {"overlap_windows": 4}}}}))
        (tmp_path / "broken.json").write_text("{nope")
        paths = [str(tmp_path / "BENCH_r01.json"),
                 str(tmp_path / "TUNE_r01.json"),
                 str(tmp_path / "broken.json"),
                 str(tmp_path / "missing.json")]
        recs = model.load_trajectory(paths)
        assert recs == ref_model.load_trajectory(paths)
        assert len(recs) == 2
        assert recs[0]["mbps"] == 100.0
        assert recs[0]["knobs"] == {"overlap_windows": 2}
        assert recs[1]["mbps"] == 140.0
        assert recs[1]["knobs"] == {"overlap_windows": 4}

    def test_checked_in_trajectory_agrees(self):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        paths = sorted(os.path.join(root, n) for n in os.listdir(root)
                       if n.endswith(".json") and n[:5] in (
                           "BENCH", "SHUFF", "SKEW_", "TUNE_"))
        assert model.load_trajectory(paths) == \
            ref_model.load_trajectory(paths)


def _handoff_record(wall, mb, edges, device_fraction=0.3, degrades=0,
                    fingerprint="fpH", rank=None):
    rec = _record(wall=wall, fingerprint=fingerprint, rank=rank, stages=[
        {"stage": 1, "kind": "map", "target": "device", "jobs": 8,
         "bytes_in": int(mb * 1e6), "bytes_out": 1000, "records_in": 10,
         "records_out": 10, "spill_bytes": 0, "seconds": wall / 2}])
    rec["device_fraction"] = device_fraction
    rec["handoff"] = {"edges": edges, "bytes": 0, "d2h_avoided_bytes": 0,
                      "degrades": degrades}
    return rec


HANDOFF_CORPORA = {
    "device-faster": [_handoff_record(4.0, 128, 1),
                      _handoff_record(6.0, 128, 0),
                      _handoff_record(4.4, 128, 1)],
    "spill-faster": [_handoff_record(6.0, 128, 1),
                     _handoff_record(4.0, 128, 0)],
    "within-margin": [_handoff_record(4.05, 128, 1),
                      _handoff_record(4.0, 128, 0)],
    "per-mb": [_handoff_record(8.0, 256, 1),
               _handoff_record(5.0, 128, 0)],
    "one-side": [_handoff_record(4.0, 128, 1),
                 _handoff_record(3.0, 128, 1)],
    "host-runs-ignored": [_handoff_record(4.0, 128, 1),
                          _handoff_record(1.0, 128, 0,
                                          device_fraction=0.0)],
    "degraded-ignored": [_handoff_record(4.0, 128, 1),
                         _handoff_record(1.0, 128, 1, degrades=2)],
    "rank-and-fingerprint-ignored": [
        _handoff_record(4.0, 128, 1), _handoff_record(5.0, 128, 0),
        _handoff_record(1.0, 128, 0, rank=1),
        _handoff_record(1.0, 128, 0, fingerprint="other")],
    "window": ([_handoff_record(1.0, 128, 0)]
               + [_handoff_record(4.0 + i * 0.01, 128, 1)
                  for i in range(9)]
               + [_handoff_record(5.0 + i * 0.01, 128, 0)
                  for i in range(8)]),
    "empty": [],
}


class TestPriceHandoff:
    @pytest.mark.parametrize("name", sorted(HANDOFF_CORPORA))
    def test_price_handoff_agrees(self, name):
        recs = HANDOFF_CORPORA[name]
        got = model.price_handoff(recs, "fpH")
        assert got == ref_model.price_handoff(recs, "fpH")
        want = {"device-faster": "device", "spill-faster": "spill",
                "within-margin": "device", "per-mb": "device",
                "window": "device",
                "rank-and-fingerprint-ignored": "device"}.get(name)
        assert got[0] == want, got

    @pytest.mark.parametrize("margin", [0.0, 0.02, 0.6])
    def test_margin_agrees(self, margin):
        old = (settings.cost_model_margin, ref_settings.cost_model_margin)
        settings.cost_model_margin = ref_settings.cost_model_margin = margin
        try:
            for recs in HANDOFF_CORPORA.values():
                assert model.price_handoff(recs, "fpH") == \
                    ref_model.price_handoff(recs, "fpH")
        finally:
            settings.cost_model_margin, ref_settings.cost_model_margin = old


class TestShuffleChoice:
    @pytest.mark.parametrize("mode", ["auto", "on", "off"])
    @pytest.mark.parametrize("n_dev", [1, 2, 8])
    def test_shuffle_choice_agrees(self, mode, n_dev):
        rng = random.Random(n_dev)
        recs = TestSearchBounds()._random_records(rng, 12)
        for st in ({"stage": 2}, {"stage": 2, "bytes_in": 1000},
                   {"stage": 2, "bytes_in": 64 << 20,
                    "records_in": 1 << 16},
                   {"stage": 2, "bytes_in": 64 << 20}, None):
            for m, rm in ((None, None),
                          (model.build(recs), ref_model.build(recs))):
                got = cost.shuffle_choice(st, n_dev, 16, mode=mode,
                                          model=m)
                assert got == ref_cost.shuffle_choice(st, n_dev, 16,
                                                      mode=mode, model=rm)

    def test_constants_are_the_jax_defaults(self):
        """The routing's two numbers are settings now, as in the JAX
        package, with its defaults."""
        assert settings.exchange_min_bytes == \
            ref_settings.exchange_min_bytes == 4 * 1024 ** 2
        assert settings.exchange_hbm_budget == \
            ref_settings.exchange_hbm_budget == 64 * 1024 ** 2


class TestTuned:
    def _write_tuned(self, name, doc):
        d = os.path.join(settings.scratch_root, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "tuned.json"), "w") as f:
            f.write(doc if isinstance(doc, str) else json.dumps(doc))

    @pytest.mark.parametrize("doc", [
        {"schema": "dampr-tpu-tuned/1", "session": "s1",
         "knobs": {"n_partitions": 8}},
        "[1, 2]", "{broken", None])
    def test_load_tuned_agrees(self, isolated, doc):
        if doc is not None:
            self._write_tuned("tuned-read", doc)
        assert cost.load_tuned("tuned-read") == \
            ref_cost.load_tuned("tuned-read")
        assert cost.load_tuned(None) is None

    # A winner the median path never picks: its partition floor is
    # max(4, min(max_processes, partitions)), so with 8 cores it picks 8,
    # the value the JAX package's version of these two tests writes.
    def _tuned_p(self):
        return settings.max_processes + 5

    def test_tuned_winner_applies_next_run(self, isolated):
        for _ in range(4):
            _run("loop")
        self._write_tuned("loop", {"schema": "dampr-tpu-tuned/1",
                                   "session": "s1", "run": "loop",
                                   "knobs": {"n_partitions":
                                             self._tuned_p()},
                                   "wall_seconds": 0.01})
        s = _run("loop")
        c = s["plan"]["cost"]
        assert c["source"] == "model", c
        applied = {ch["knob"]: ch for ch in c["choices"]
                   if ch.get("applied")}
        assert applied["n_partitions"]["chosen"] == self._tuned_p()
        assert "autotuned winner" in applied["n_partitions"]["reason"]
        assert c["tuned"]["session"] == "s1"
        assert s["n_partitions"] == self._tuned_p()

    def test_stale_fingerprint_tuned_never_applies(self, isolated):
        for _ in range(4):
            _run("stale")
        self._write_tuned("stale", {"schema": "dampr-tpu-tuned/1",
                                    "session": "sX", "run": "stale",
                                    "fingerprint": "deadbeef" * 2,
                                    "knobs": {"n_partitions":
                                              self._tuned_p()}})
        s = _run("stale")
        c = s["plan"]["cost"]
        assert c.get("tuned_stale", {}).get("session") == "sX", c
        for ch in c["choices"]:
            assert not (ch["knob"] == "n_partitions"
                        and "autotuned" in (ch.get("reason") or "")), ch
        assert s["n_partitions"] != self._tuned_p()
