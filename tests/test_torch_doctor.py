"""The doctor of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_doctor.py``'s doctor cases.  Traced port
runs of several pipeline shapes (a scanner-bound TF-IDF run, a fold that
spills under a small budget, a cache that thrashes, two runs diffed) are
diagnosed by the JAX package's ``doctor.diagnose``/``diff`` and by the
port's, on the same ``stats.json``, with both packages' scratch and trace
roots pointed at one directory: the verdicts, stages, ranks, severities,
evidence and ``impact_seconds`` (to 1e-9) are equal, and the suggestions
differ only as the knob map says (the port leaves out
``doctor.MESH_KNOBS`` and names each knob's ``DAMPR_TPU_TORCH_*``
variable).  The port's ``--json`` report validates against
``docs/doctor_schema.json``.  Inputs are seeded.
"""

import importlib.util
import json
import math
import operator
import os

import numpy as np
import pytest

import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.obs import doctor as ref_doctor
from dampr_tpu_torch import runner, settings
from dampr_tpu_torch.obs import critpath, doctor, history
from dampr_tpu_torch.ops.text import DocFreq

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


validate_doctor = _load_tool("validate_doctor")

with open(os.path.join(ROOT, "docs", "doctor_schema.json")) as _f:
    DOCTOR_SCHEMA = json.load(_f)

#: The JAX playbook's knobs the port leaves out, pinned.
LEFT_OUT = {"lower_min_records", "spill_inflight_bytes",
            "spill_read_threads"}


@pytest.fixture
def diagnosed(tmp_path):
    """Tracing on; both packages' scratch and trace roots in one place,
    so either doctor reads the port run's corpus, telemetry and faults;
    the port on the CPU."""
    names = ("trace", "trace_dir", "scratch_root")
    old = {s: {n: getattr(s, n) for n in names}
           for s in (settings, ref_settings)}
    old_dev = settings.device
    for s in (settings, ref_settings):
        s.trace = True
        s.trace_dir = str(tmp_path / "traces")
        s.scratch_root = str(tmp_path / "scratch")
    settings.device = "cpu"
    yield tmp_path
    for s, vals in old.items():
        for n, v in vals.items():
            setattr(s, n, v)
    settings.device = old_dev


def _corpus(tmp_path, lines=6000, seed=5):
    rng = np.random.RandomState(seed)
    words = ["alpha", "beta", "gamma", "delta", "tok7", "zz", "mu", "xi"]
    path = tmp_path / "corpus.txt"
    with open(path, "w") as f:
        for _ in range(lines):
            f.write(" ".join(words[i] for i in rng.randint(0, 8, 9)) + "\n")
    return str(path)


def _tfidf_run(tmp_path, name):
    docs = dampr_tpu_torch.Dampr.text(_corpus(tmp_path), 1 << 17)
    df = (docs.custom_mapper(DocFreq(mode="word", lower=True))
          .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))
    idf = df.cross_right(
        docs.len(),
        lambda d, total: (d[0], d[1], math.log(1 + float(total) / d[1])),
        memory=True)
    em = idf.run(name)
    path = em.stats()["stats_file"]
    em.delete()
    return path


def _spill_run(tmp_path, name):
    """A fold over 40,000 distinct seeded keys under a 64 KiB budget."""
    keys = np.random.RandomState(11).randint(0, 1 << 40, 40000).tolist()
    old = settings.max_memory_per_stage
    settings.max_memory_per_stage = 64 * 1024
    try:
        em = (dampr_tpu_torch.Dampr.memory(keys, partitions=8)
              .map(lambda k: ("k{}".format(k), 1))
              .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1])
              .run(name))
    finally:
        settings.max_memory_per_stage = old
    stats = em.stats()
    em.delete()
    assert stats["store"]["spilled_bytes"] > 0
    return stats["stats_file"]


def _thrash_run(tmp_path, name):
    """Two cached word counts over different files under a budget that
    holds one of them: the second evicts the first."""
    old = (settings.reuse, settings.reuse_dir, settings.reuse_budget_bytes)
    settings.reuse = "on"
    settings.reuse_dir = str(tmp_path / "cache")
    try:
        def wc(d, run):
            return (dampr_tpu_torch.Dampr.text(d)
                    .flat_map(lambda line: line.split())
                    .fold_by(lambda w: w, operator.add, lambda w: 1)
                    .run(run))

        first = wc(_corpus(tmp_path, 2000, seed=1), name + "-a")
        settings.reuse_budget_bytes = int(
            first.stats()["reuse"]["bytes_published"] * 1.25)
        os.makedirs(str(tmp_path / "b"))
        second = wc(_corpus(tmp_path / "b", 2000, seed=2), name)
        stats = second.stats()
        first.delete()
        second.delete()
    finally:
        settings.reuse, settings.reuse_dir, settings.reuse_budget_bytes = old
    assert stats["reuse"]["evictions"] >= 1
    return stats["stats_file"]


def _port_env(env):
    return env.replace("DAMPR_TPU_", "DAMPR_TPU_TORCH_") if env else env


def _assert_suggestions_map(ref_sugs, port_sugs, snapshot):
    """The port's suggestions are the JAX ones less the left-out knobs,
    each naming the port's variable; a knob's current and suggested
    values agree where both doctors read the run's own value."""
    kept = [s for s in ref_sugs if s["setting"] not in LEFT_OUT]
    assert [s["setting"] for s in port_sugs] == [
        s["setting"] for s in kept]
    for r, p in zip(kept, port_sugs):
        assert p.get("env") == _port_env(r.get("env"))
        assert p["why"] == _port_env(r["why"])
        k = r["setting"]
        if k in snapshot or getattr(ref_settings, k, None) == \
                history.knob_value(k):
            assert (p["current"], p["suggested"]) == (
                r["current"], r["suggested"]), k


def _assert_same_diagnosis(ref, port):
    for key in ("schema", "run", "wall_seconds", "bottleneck",
                "critpath_source", "stages", "history_entries", "crashed"):
        assert ref.get(key) == port.get(key), key
    assert set(ref) == set(port)
    assert len(ref["findings"]) == len(port["findings"])
    snapshot = (history.load(port["run"]) or [{}])[-1].get("settings", {})
    for r, p in zip(ref["findings"], port["findings"]):
        for key in ("stage", "bottleneck", "rank", "severity", "evidence"):
            assert r[key] == p[key], (key, r, p)
        assert abs(r["impact_seconds"] - p["impact_seconds"]) <= 1e-9
        _assert_suggestions_map(r["suggestions"], p["suggestions"],
                                snapshot)
    assert validate_doctor.validate(port, DOCTOR_SCHEMA,
                                    check_settings=False) == []


SHAPES = {"scanner": _tfidf_run, "spill": _spill_run, "thrash": _thrash_run}


class TestAgainstJax:
    @pytest.mark.parametrize("shape", sorted(SHAPES))
    def test_same_verdicts(self, diagnosed, shape):
        path = SHAPES[shape](diagnosed, "doc-" + shape)
        ref, port = ref_doctor.diagnose(path), doctor.diagnose(path)
        assert port["findings"], port
        _assert_same_diagnosis(ref, port)
        assert doctor.format_report(port).splitlines()[0] == \
            ref_doctor.format_report(ref).splitlines()[0]

    def test_spill_run_names_a_spill_verdict(self, diagnosed):
        rep = doctor.diagnose(_spill_run(diagnosed, "doc-spill-v"))
        verdicts = {s["verdict"] for s in rep["stages"]}
        assert verdicts & {"spill-write", "spill-queue", "merge",
                           "io-read"}, rep["stages"]

    def test_thrash_finding(self, diagnosed):
        rep = doctor.diagnose(_thrash_run(diagnosed, "doc-thrash-f"))
        found = [f for f in rep["findings"]
                 if f["bottleneck"] == "reuse-thrash"]
        assert found
        assert [s["env"] for s in found[0]["suggestions"]] == [
            "DAMPR_TPU_TORCH_REUSE_BUDGET", "DAMPR_TPU_TORCH_REUSE_DIR"]

    def test_diff_of_two_runs(self, diagnosed, monkeypatch):
        a = _tfidf_run(diagnosed, "diff-a")
        monkeypatch.setattr(runner, "OVERLAP_WINDOWS",
                            runner.OVERLAP_WINDOWS + 5)
        b = _tfidf_run(diagnosed, "diff-b")
        ref, port = ref_doctor.diff(a, b), doctor.diff(a, b)
        assert port == ref
        delta = port["diff"]["settings_delta"]
        assert delta["overlap_windows"] == {
            "a": runner.OVERLAP_WINDOWS - 5, "b": runner.OVERLAP_WINDOWS}
        assert validate_doctor.validate(port, DOCTOR_SCHEMA,
                                        check_settings=False) == []
        assert doctor.format_report(port) == ref_doctor.format_report(ref)

    def test_regression_finding_matches(self, diagnosed, monkeypatch):
        """Four runs of one shape, the newest made slow: the sentry's
        regression finding reads the same in both doctors."""
        for _ in range(4):
            path = _tfidf_run(diagnosed, "doc-reg")
        from dampr_tpu_torch.obs import timeseries

        pts = timeseries.load("doc-reg")
        slow = dict(pts[-1], wall_seconds=pts[-1]["wall_seconds"] * 50,
                    ts=pts[-1]["ts"] + 1)
        timeseries.append_point(slow)
        ref, port = ref_doctor.diagnose(path), doctor.diagnose(path)
        regs = [f for f in port["findings"] if f["bottleneck"] ==
                "regression"]
        assert regs and "wall_seconds" in regs[0]["evidence"]
        _assert_same_diagnosis(ref, port)


class TestPlaybook:
    def test_left_out_knobs_pinned(self):
        ref_knobs = {k for entries in ref_doctor._PLAYBOOK.values()
                     for k, _e, _p, _w in entries}
        port_knobs = {k for entries in doctor._PLAYBOOK.values()
                      for k, _e, _p, _w in entries}
        assert ref_knobs - port_knobs == LEFT_OUT
        assert set(doctor.MESH_KNOBS) == LEFT_OUT
        assert port_knobs <= ref_knobs

    def test_every_verdict_kept(self):
        assert set(doctor._PLAYBOOK) == set(ref_doctor._PLAYBOOK)

    def test_playbook_knobs_exist(self):
        """Every suggestion names a knob the port has, with the variable
        the port reads it from."""
        for verdict, entries in doctor._PLAYBOOK.items():
            for knob, env, _prop, why in entries:
                assert history.knob_home(knob) is not None, (verdict, knob)
                assert why
                if env:
                    assert env.startswith("DAMPR_TPU_TORCH_"), env

    def test_suggestions_use_run_settings_not_process(self):
        rs = {"spill_write_threads": 8}
        by = {s["setting"]: s for s in doctor._suggestions_for(
            "spill-queue", {}, run_settings=rs)}
        assert by["spill_write_threads"]["current"] == 8
        assert by["spill_write_threads"]["suggested"] == 16

    def test_constant_knob_current_value(self, monkeypatch):
        """A knob the port keeps as a module constant reads its value
        there."""
        monkeypatch.setattr(runner, "OVERLAP_WINDOWS", 3)
        by = {s["setting"]: s for s in doctor._suggestions_for(
            "overlap-stall", {}, run_settings={})}
        assert by["overlap_windows"]["current"] == 3
        assert by["overlap_windows"]["suggested"] == 6
        assert by["overlap_windows"]["env"] == \
            "DAMPR_TPU_TORCH_OVERLAP_WINDOWS"

    def test_run_settings_sources(self):
        summary = {"io": {"writer_threads": 5, "read_prefetch": 7},
                   "overlap": {"windows": 9},
                   "metrics": {"sampler": {"interval_ms": 250}}}
        hist = [{"settings": {"spill_write_threads": 1, "partitions": 32}}]
        assert doctor._run_settings(summary, hist) == \
            ref_doctor._run_settings(summary, hist)


class TestDoctor:
    def test_diagnose_traced_run_schema_valid(self, diagnosed):
        path = _tfidf_run(diagnosed, "doc-run")
        report = doctor.diagnose("doc-run")
        assert report == doctor.diagnose(path)
        assert validate_doctor.validate(report, DOCTOR_SCHEMA,
                                        check_settings=False) == []
        assert report["bottleneck"] and report["stages"]
        assert not report["crashed"]
        assert report["bottleneck"] in doctor.format_report(report)

    def test_findings_ranked_by_impact(self, diagnosed):
        report = doctor.diagnose(_tfidf_run(diagnosed, "doc-rank"))
        impacts = [f["impact_seconds"] for f in report["findings"]]
        assert impacts == sorted(impacts, reverse=True)
        assert [f["rank"] for f in report["findings"]] == list(
            range(1, len(impacts) + 1))

    def test_threadseconds_impact_clamped_to_wall(self, diagnosed):
        stats = {
            "schema": "dampr-tpu-stats/1", "run": "clamp-run",
            "wall_seconds": 10.0, "stages": [],
            "io": {"io_wait_write_fraction": 1.6,
                   "io_wait_write_seconds": 16.0,
                   "io_wait_fraction": 1.6},
            "devtime": {}, "overlap": {}, "device": {},
        }
        p = diagnosed / "stats.json"
        with open(p, "w") as f:
            json.dump(stats, f)
        rep = doctor.diagnose(str(p))
        f = [x for x in rep["findings"] if x["bottleneck"] == "spill-queue"]
        assert f and f[0]["impact_seconds"] <= 10.0
        assert "thread-seconds" in f[0]["evidence"]
        _assert_same_diagnosis(ref_doctor.diagnose(str(p)), rep)

    def test_missing_run_raises(self, diagnosed):
        with pytest.raises(doctor.DoctorError):
            doctor.diagnose("no-such-run")

    def test_cli_exit_codes(self, diagnosed, capsys):
        assert doctor.main(["no-such-run"]) == 2
        _tfidf_run(diagnosed, "doc-cli")
        assert doctor.main(["doc-cli"]) == 0
        assert "bottleneck" in capsys.readouterr().out
        assert doctor.main(["doc-cli", "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["schema"] == doctor.SCHEMA
        assert validate_doctor.validate(report, DOCTOR_SCHEMA,
                                        check_settings=False) == []

    def test_from_run_recomputes_from_trace(self, diagnosed):
        """A stats.json without its critpath section: the section is
        recomputed from the trace beside it, as the JAX package does."""
        from dampr_tpu.obs import critpath as ref_critpath

        path = _tfidf_run(diagnosed, "doc-recompute")
        with open(path) as f:
            summary = json.load(f)
        summary.pop("critpath")
        with open(path, "w") as f:
            json.dump(summary, f)
        section, got = critpath.from_run(path)
        assert got["run"] == "doc-recompute"
        assert section["source"] == "spans"
        assert section == ref_critpath.from_run(path)[0]
        assert critpath.from_run(str(diagnosed / "nothing")) == (None, None)
