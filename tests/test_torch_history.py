"""The run-history corpus of dampr_tpu_torch against dampr_tpu's.

``dampr_tpu_torch/obs/history.py`` is a copy of the JAX module's record
schema and functions: a port record must load in
``dampr_tpu.obs.history.load``, and ``compact_record``, ``matching``,
``synthesize``, ``vacuum``, ``schema_version``/``upgrade`` and
``plan_fingerprint`` must give the JAX functions' results on the same
inputs.  The one stated difference is a record's ``settings`` snapshot:
each package records its own settings (same keys).  A failed run appends
nothing.  Inputs are seeded; every comparison is exact.
"""

import json
import operator
import os
import random

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import history as ref_history
from dampr_tpu.plan import ir as ref_ir
from dampr_tpu.plan import passes as ref_passes
from dampr_tpu_torch import settings
from dampr_tpu_torch.obs import history
from dampr_tpu_torch.plan import ir, passes


@pytest.fixture(autouse=True)
def roots(tmp_path):
    """Both packages read and write one scratch root of this test's."""
    old = (settings.device, settings.scratch_root, settings.history_entries,
           ref_settings.scratch_root, ref_settings.history_entries)
    settings.device = "cpu"
    settings.scratch_root = ref_settings.scratch_root = str(
        tmp_path / "scratch")
    yield tmp_path
    (settings.device, settings.scratch_root, settings.history_entries,
     ref_settings.scratch_root, ref_settings.history_entries) = old


def _fold(pkg, n=3000, mod=7):
    return (pkg.Dampr.memory(list(range(n)), partitions=4)
            .map(lambda x: (x % mod, x))
            .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))


def _run(pkg, name, build=_fold):
    em = build(pkg).run(name=name)
    out = em.read()
    stats = em.stats()
    em.delete()
    return out, stats


def _without_settings(rec):
    rec = dict(rec)
    rec.pop("settings")
    return rec


def _stage(rng, sid, kind):
    return {"stage": sid, "kind": kind, "target": "host",
            "shuffle_target": None, "jobs": rng.choice([1, 4, 8, 64]),
            "records_in": rng.randrange(0, 10 ** 6),
            "records_out": rng.randrange(0, 10 ** 6),
            "bytes_in": rng.randrange(0, 10 ** 9),
            "bytes_out": rng.randrange(0, 10 ** 9),
            "spill_bytes": rng.randrange(0, 10 ** 6),
            "seconds": rng.random() * 10}


def _records(seed, n, run="r", shapes=None):
    """``n`` seeded corpus records in the JAX schema."""
    rng = random.Random(seed)
    shapes = shapes or [{"sid": 1, "shape": "map:ValueMap.Rekey+c"},
                        {"sid": 2, "shape": "reduce:AssocFoldReducer"}]
    out = []
    for i in range(n):
        rec = {"schema": history.SCHEMA, "v": history.SCHEMA_VERSION,
               "run": run, "ts": 1000.0 + i,
               "wall_seconds": 0.5 + rng.random(),
               "n_partitions": rng.choice([4, 8, 64]),
               "stage_shapes": shapes,
               "stages": [_stage(rng, 1, "map"), _stage(rng, 2, "reduce")],
               "throughput": {"mbps": rng.random() * 100},
               "settings": {}, "health": {},
               "fingerprint": history.plan_fingerprint(shapes)}
        if rng.random() < 0.2:
            rec["rank"] = 1
        out.append(rec)
    return out


class TestRecords:
    def test_port_records_load_in_the_jax_package(self):
        for _ in range(3):
            want, _stats = _run(dampr_tpu_torch, "hist-load")
        recs = history.load("hist-load")
        assert len(recs) == 3
        ref_recs = ref_history.load("hist-load")
        assert ref_recs == recs
        for rec in ref_recs:
            assert ref_history.schema_version(rec) == \
                ref_history.SCHEMA_VERSION
            assert rec["fingerprint"] == ref_history.plan_fingerprint(
                rec["stage_shapes"])
        assert ref_history.matching(ref_recs, recs[-1]["stage_shapes"]) \
            == ref_recs

    @pytest.mark.parametrize("source", ["port", "jax"])
    def test_compact_record_agrees(self, source, tmp_path):
        pkg = dampr_tpu_torch if source == "port" else dampr_tpu
        old = (ref_settings.mesh_fold, ref_settings.mesh_exchange)
        # the JAX side's single-device branches
        ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
        try:
            _out, summary = _run(pkg, "hist-compact-" + source)
        finally:
            ref_settings.mesh_fold, ref_settings.mesh_exchange = old
        port = history.compact_record(summary)
        ref = ref_history.compact_record(summary)
        assert _without_settings(port) == _without_settings(ref)
        assert set(port["settings"]) == set(ref["settings"])
        assert json.loads(json.dumps(port, default=str))["stages"] == \
            port["stages"]

    def test_settings_snapshot_reads_the_port_knobs(self):
        from dampr_tpu_torch import runner, storage

        snap = history.compact_record(
            {"run": "x", "stages": [], "plan": {}})["settings"]
        assert snap["overlap_windows"] == runner.OVERLAP_WINDOWS
        assert snap["spill_read_prefetch"] == storage.SPILL_READ_PREFETCH
        assert snap["spill_codec"] == str(storage.SPILL_CODEC)
        assert snap["pipeline"] == settings.pipeline
        assert snap["exchange_hbm_budget"] == 64 * 1024 ** 2
        # the straggler mitigation's knobs are the port's since A5b
        assert snap["mitigate"] == settings.mitigate == "off"
        assert snap["speculate_threshold"] == settings.speculate_threshold

    def test_stage_shapes_and_fingerprints_agree(self):
        def pipes(pkg):
            d = pkg.Dampr.memory(list(range(100)))
            return [
                _fold(pkg),
                d.map(lambda x: x + 1).filter(lambda x: x % 3),
                d.sort_by(lambda x: -x),
                d.group_by(lambda x: x % 4).reduce(lambda k, vs: sum(vs)),
                d.count(lambda x: x % 5),
                d.map(lambda x: (x, 1)).checkpoint().len(),
            ]

        for rp, pp in zip(pipes(dampr_tpu), pipes(dampr_tpu_torch)):
            rg, _ = ref_passes.optimize(rp.pmer.graph, [rp.source])
            pg, _ = passes.optimize(pp.pmer.graph, [pp.source])
            assert ir.stage_shapes(pg) == ref_ir.stage_shapes(rg)
            assert history.plan_fingerprint(ir.stage_shapes(pg)) == \
                ref_history.plan_fingerprint(ref_ir.stage_shapes(rg))


class TestFunctions:
    @pytest.mark.parametrize("tag", [None, "bogus", "dampr-tpu-history/1",
                                     "dampr-tpu-history/2",
                                     "dampr-tpu-history/3",
                                     "dampr-tpu-history/4",
                                     "dampr-tpu-history/x", 7])
    def test_schema_version_and_upgrade(self, tag):
        rec = {"schema": tag, "stages": [{"stage": 1}]}
        assert history.schema_version(rec) == ref_history.schema_version(rec)
        assert history.upgrade(json.loads(json.dumps(rec))) == \
            ref_history.upgrade(json.loads(json.dumps(rec)))

    @pytest.mark.parametrize("n", [1, 2, 3, 5, 9])
    def test_synthesize_agrees(self, n):
        recs = [r for r in _records(n, n) if not r.get("rank")] or \
            _records(n, 1)
        assert history.synthesize(recs) == ref_history.synthesize(recs)
        assert history.synthesize([]) is ref_history.synthesize([]) is None

    @pytest.mark.parametrize("seed", range(4))
    def test_matching_agrees(self, seed):
        other = [{"sid": 1, "shape": "map:DocFreq+c"},
                 {"sid": 2, "shape": "reduce:AssocFoldReducer"}]
        recs = _records(seed, 6) + _records(seed + 10, 4, shapes=other)
        random.Random(seed).shuffle(recs)
        for shapes in (recs[0]["stage_shapes"], other, [], None):
            got = history.matching(recs, shapes)
            assert got == ref_history.matching(recs, shapes)
            assert not any(r.get("rank") for r in got)

    @pytest.mark.parametrize("cap", [0, 2, 64])
    def test_vacuum_agrees(self, tmp_path, cap):
        lines = [json.dumps(r) for r in _records(3, 5)]
        v1 = dict(_records(4, 1)[0], schema="dampr-tpu-history/1")
        v1.pop("v")
        lines += [json.dumps(v1), "not json", "",
                  json.dumps({"schema": "dampr-tpu-history/99",
                              "stages": []}),
                  json.dumps({"schema": history.SCHEMA, "stages": "x"})]
        port_path = str(tmp_path / "port.jsonl")
        ref_path = str(tmp_path / "ref.jsonl")
        for p in (port_path, ref_path):
            with open(p, "w") as f:
                f.write("\n".join(lines) + "\n")
        assert history.vacuum(port_path, cap) == \
            ref_history.vacuum(ref_path, cap)
        with open(port_path) as a, open(ref_path) as b:
            assert a.read() == b.read()
        assert history.vacuum(str(tmp_path / "missing"), cap) == (0, 0)

    def test_compaction_keeps_the_newest(self):
        settings.history_entries = ref_settings.history_entries = 3
        stamps = []
        for _ in range(5):
            _out, stats = _run(dampr_tpu_torch, "hist-cap")
            stamps.append(stats["started_at"])
        recs = history.load("hist-cap")
        assert [r["ts"] for r in recs] == stamps[-3:]
        assert ref_history.load("hist-cap") == recs

    def test_corrupt_lines_are_skipped(self):
        _run(dampr_tpu_torch, "hist-corrupt")
        path = history.corpus_path("hist-corrupt")
        with open(path, "a") as f:
            f.write("{truncated\n")
        _run(dampr_tpu_torch, "hist-corrupt")
        recs = history.load("hist-corrupt")
        assert len(recs) == 2
        assert ref_history.load("hist-corrupt") == recs


class TestAppend:
    def test_failed_run_appends_nothing(self):
        def boom(x):
            if x == 1500:
                raise ValueError("boom")
            return x

        _run(dampr_tpu_torch, "hist-fail")
        with pytest.raises(ValueError):
            dampr_tpu_torch.Dampr.memory(list(range(3000))).map(boom) \
                .run(name="hist-fail")
        with pytest.raises(ValueError):
            _run(dampr_tpu_torch, "hist-fail-only",
                 lambda pkg: pkg.Dampr.memory(list(range(3000))).map(boom))
        assert len(history.load("hist-fail")) == 1
        assert not os.path.exists(history.corpus_path("hist-fail-only"))

    def test_disabled_and_degenerate_summaries_append_nothing(self):
        settings.history_entries = 0
        _run(dampr_tpu_torch, "hist-off")
        assert history.load("hist-off") == []
        settings.history_entries = 64
        assert history.append({"run": None, "stages": [{}]}) is None
        assert history.append({"run": "x", "stages": []}) is None
        assert history.load(None) == []

    def test_unwritable_corpus_never_fails_the_run(self, tmp_path,
                                                   monkeypatch):
        blocker = tmp_path / "file"
        blocker.write_text("x")
        monkeypatch.setattr(history, "corpus_path",
                            lambda run: str(blocker / "history.jsonl"))
        got, _stats = _run(dampr_tpu_torch, "hist-ro")
        assert got == _run(dampr_tpu_torch, None)[0]
        assert blocker.read_text() == "x"
