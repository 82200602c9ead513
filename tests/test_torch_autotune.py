"""The autotune loop of dampr_tpu_torch against dampr_tpu's, and C3.

The port versions of ``tests/test_cost_model.py::TestAutotuneSession``,
``TestCheckBenchSatellites`` and
``TestSearchBounds::test_candidate_vectors_stay_in_bounds``: the
in-process session picks the fastest byte-identical trial, restores every
knob (settings and the module constants the port keeps), persists the
winner that the next run's cost layer applies; a divergent trial is
never crowned; ``candidate_vectors`` equals the JAX one on the same
corpus file; ``tools/check_bench.py`` reads a port session's report as a
baseline.  The subprocess form runs a tiny pipeline per trial and the
knob vector reaches the trial through ``as_env``.

C3: every knob the port's ``plan.model.ENV_OF`` names a variable for is
read from that variable in a fresh process (``history.knob_value``), and
the JAX package reads the same value under its own name.
"""

import importlib.util
import json
import os
import random
import subprocess
import sys

import pytest

import dampr_tpu.plan.model as ref_model
from dampr_tpu.obs import autotune as ref_autotune
from dampr_tpu_torch import Dampr, runner, settings
from dampr_tpu_torch.obs import autotune, history
from dampr_tpu_torch.plan import cost, model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


validate_doctor = _load_tool("validate_doctor")
check_bench = _load_tool("check_bench")

with open(os.path.join(ROOT, "docs", "doctor_schema.json")) as _f:
    DOCTOR_SCHEMA = json.load(_f)


@pytest.fixture
def isolated(tmp_path):
    """The port on the CPU under this test's scratch root, the model on,
    the autotune settings restored."""
    from dampr_tpu import settings as ref_settings

    old = (settings.device, settings.scratch_root, settings.cost_model,
           settings.autotune, settings.autotune_trials,
           ref_settings.scratch_root)
    settings.device = "cpu"
    settings.scratch_root = ref_settings.scratch_root = str(
        tmp_path / "scratch")
    settings.cost_model = "auto"
    yield tmp_path
    (settings.device, settings.scratch_root, settings.cost_model,
     settings.autotune, settings.autotune_trials,
     ref_settings.scratch_root) = old


def _fold_pipeline(out=None):
    p = (Dampr.memory([(i % 50, 1) for i in range(30000)])
         .fold_by(lambda kv: kv[0], lambda a, b: a + b, lambda kv: kv[1]))
    return p.sink_tsv(out) if out else p


def _run(name, out=None):
    em = _fold_pipeline(out).run(name)
    s = em.stats()
    em.delete()
    return s


class TestAutotuneSession:
    def _measure_factory(self, walls_by_overlap):
        calls = []

        def measure():
            w = walls_by_overlap.get(runner.OVERLAP_WINDOWS, 1.0)
            calls.append(runner.OVERLAP_WINDOWS)
            return w, "result-token"

        return measure, calls

    def test_winner_and_restore(self, isolated):
        settings.autotune_trials = 3
        old_overlap = runner.OVERLAP_WINDOWS
        # the exploration schedule tries overlap 0 first (from 2): make
        # it the fast configuration so a non-baseline trial wins
        measure, calls = self._measure_factory({old_overlap: 1.0,
                                                0: 0.4, 4: 0.4, 8: 0.4})
        best, report = autotune.tune_settings_session(
            measure, "tune-unit", digest_of=lambda r: "d0",
            out=lambda m: None)
        a = report["autotune"]
        assert runner.OVERLAP_WINDOWS == old_overlap  # restored
        assert calls[:2] == [old_overlap, 0]
        assert a["byte_identical"] is True
        assert a["winner"]["trial"] != 0
        assert a["improvement"] >= 2.0
        assert best == "result-token"
        tuned = cost.load_tuned("tune-unit")
        assert tuned and tuned["knobs"] == {"overlap_windows": 0}
        assert validate_doctor.validate(report, DOCTOR_SCHEMA,
                                        check_settings=False) == []

    def test_setting_knob_restored(self, isolated):
        """A knob that is a setting (``spill_write_threads``) is set for
        its trial and restored after, as a constant knob is."""
        seen = []

        def measure():
            seen.append((runner.OVERLAP_WINDOWS,
                         settings.spill_write_threads))
            return 1.0, None

        settings.autotune_trials = 3
        old = settings.spill_write_threads
        autotune.tune_settings_session(measure, "tune-set",
                                       out=lambda m: None)
        assert seen[2] == (runner.OVERLAP_WINDOWS, 0)
        assert settings.spill_write_threads == old

    def test_divergent_output_disqualifies(self, isolated):
        settings.autotune_trials = 3
        digests = iter(["base", "DIFFERENT", "base2"])

        def measure():
            return 0.1 if runner.OVERLAP_WINDOWS != 2 else 1.0, None

        _best, report = autotune.tune_settings_session(
            measure, "tune-div", digest_of=lambda r: next(digests),
            out=lambda m: None)
        a = report["autotune"]
        assert a["byte_identical"] is False
        disq = [t for t in a["trials"] if t.get("byte_identical") is False]
        assert disq
        assert all(a["winner"]["trial"] != t["trial"] for t in disq)

    def test_session_winner_applies_next_run(self, isolated):
        """The closed loop on real runs: a session over a named fold
        persists its winner with the plan's fingerprint, and a winner
        carrying ``n_partitions`` is applied by the next run."""
        out = str(isolated / "loop-out")
        for _ in range(4):
            _run("loop", out=out)

        def measure():
            s = _run("loop", out=out)
            return s["wall_seconds"], None

        settings.autotune_trials = 2
        _best, report = autotune.tune_settings_session(
            measure, "loop", digest_of=lambda r: autotune.dir_digest(out),
            out=lambda m: None)
        assert report["autotune"]["byte_identical"] is True
        fp = history.load("loop")[-1]["fingerprint"]
        p = settings.max_processes + 5
        autotune._persist_winner("loop", "s1", {
            "knobs": {"n_partitions": p}, "fingerprint": fp})
        s = _run("loop", out=out)
        applied = {c["knob"]: c for c in s["plan"]["cost"]["choices"]
                   if c.get("applied")}
        assert applied["n_partitions"]["chosen"] == p
        assert s["n_partitions"] == p

    def test_as_env_maps_only_env_knobs(self):
        env = autotune.as_env({"overlap_windows": 4, "n_partitions": 8,
                               "spill_codec": "zstd",
                               "exchange_hbm_budget": 1 << 26})
        assert env == {"DAMPR_TPU_TORCH_OVERLAP_WINDOWS": "4",
                       "DAMPR_TPU_TORCH_SPILL_CODEC": "zstd",
                       "DAMPR_TPU_TORCH_EXCHANGE_HBM": str(1 << 26)}

    def test_dir_digest_equals_jax(self, tmp_path):
        d = tmp_path / "out"
        d.mkdir()
        (d / "a.txt").write_text("alpha\nbeta\n")
        one = autotune.dir_digest(str(d))
        assert one == ref_autotune.dir_digest(str(d))
        tree_one = autotune.dir_digest(str(d), mode="tree")
        assert tree_one == ref_autotune.dir_digest(str(d), mode="tree")
        (d / "a.txt").write_text("beta\n")
        (d / "b.txt").write_text("alpha\n")
        assert autotune.dir_digest(str(d)) == one
        assert autotune.dir_digest(str(d), mode="tree") != tree_one
        assert autotune.dir_digest(str(tmp_path / "missing")) is None


def _record(rng, i):
    stages = []
    for sid, kind in ((1, "map"), (2, "reduce")):
        stages.append({
            "stage": sid, "kind": kind,
            "target": rng.choice(["host", "host", "device"]),
            "shuffle_target": rng.choice([None, "host"]),
            "jobs": rng.choice([1, 4, 64, 256]),
            "bytes_in": rng.randrange(0, 1 << 31),
            "bytes_out": rng.randrange(0, 1 << 31),
            "records_in": rng.randrange(0, 1 << 20),
            "records_out": rng.randrange(0, 1 << 20),
            "spill_bytes": rng.choice([0, 1 << 20]),
            "seconds": rng.random() * 100})
    return {
        "schema": history.SCHEMA, "run": "bounds-run", "ts": 1000.0 + i,
        "wall_seconds": rng.random() * 10 + 0.1, "n_partitions": 64,
        "stage_shapes": [{"sid": 1, "shape": "map:DocFreq+c"},
                         {"sid": 2, "shape": "reduce:AssocFoldReducer"}],
        "stages": stages,
        "throughput": {"mbps": rng.random() * 500},
        "settings": {
            "overlap_windows": rng.choice([0, 2, 4, 8]),
            "spill_write_threads": rng.choice([0, 2, 8]),
            "spill_read_prefetch": rng.choice([0, 2]),
            "merge_fanin": rng.choice([4, 64, 512, 4096]),
            "spill_codec": rng.choice(["auto", "zstd", "zlib"])},
        "fingerprint": "fp0",
        "critpath": {"run": rng.choice(["codec", "merge", "spill-queue",
                                        "io-read"])},
    }


def _write_bounds_corpus(seed, n=6):
    rng = random.Random(seed)
    path = history.corpus_path("bounds-run")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps(_record(rng, i), default=str) + "\n")


class TestSearchBounds:
    def test_candidate_vectors_stay_in_bounds(self, isolated):
        _write_bounds_corpus(5)
        for cand in autotune.candidate_vectors("bounds-run", 8):
            for knob, val in cand["knobs"].items():
                assert model.in_bounds(knob, val), (knob, val)

    @pytest.mark.parametrize("seed", [5, 6, 7, 8])
    def test_candidate_vectors_equal_jax(self, isolated, seed):
        """The same corpus file gives the JAX package's vectors (the
        verdicts a single card records; a fleet's ``skew`` and the mesh
        verdicts are A5's)."""
        _write_bounds_corpus(seed)
        for n in (1, 3, 8):
            assert autotune.candidate_vectors("bounds-run", n) == \
                ref_autotune.candidate_vectors("bounds-run", n)

    def test_empty_corpus_explores(self, isolated):
        got = autotune.candidate_vectors("never-ran", 3)
        assert got == ref_autotune.candidate_vectors("never-ran", 3)
        assert [c["why"] for c in got] == ["exploration schedule"] * 3


class TestCheckBenchSatellites:
    def _port_report(self, isolated, mbps=120.0):
        settings.autotune_trials = 2
        walls = iter([1.4, 1.0])
        _best, report = autotune.tune_settings_session(
            lambda: (next(walls), None), "bench-tfidf", out=lambda m: None)
        report["metric"] = "tfidf_docfreq_throughput"
        report["autotune"]["winner"]["mbps"] = mbps
        path = isolated / "TUNE_port.json"
        path.write_text(json.dumps(report))
        return str(path)

    def test_autotune_report_as_baseline(self, isolated, capsys):
        tune = self._port_report(isolated, mbps=120.0)
        rec = check_bench.load_record(tune)
        assert rec["value"] == 120.0
        assert rec["metric"] == "tfidf_docfreq_throughput"
        fresh = isolated / "fresh.json"
        fresh.write_text(json.dumps({
            "metric": "tfidf_docfreq_throughput", "value": 60.0}))
        assert check_bench.main([str(fresh), "--baseline", tune,
                                 "--tolerance", "0.25"]) == 0
        out = capsys.readouterr().out
        assert "WARN" in out and "120" in out

    def test_autotune_report_without_toplevel_value(self, isolated):
        tune = self._port_report(isolated, mbps=80.0)
        doc = json.loads(open(tune).read())
        doc.pop("metric", None)
        with open(tune, "w") as f:
            json.dump(doc, f)
        assert check_bench.load_record(tune)["value"] == 80.0

    @pytest.mark.parametrize("value,warn", [(50.0, True), (95.0, False)])
    def test_model_residual_under_trend(self, isolated, capsys, value,
                                        warn):
        fresh = isolated / "fresh.json"
        fresh.write_text(json.dumps({
            "metric": "m", "value": value, "model_predicted_value": 100.0}))
        assert check_bench.main([str(fresh), "--trend",
                                 "--tolerance", "0.25"]) == 0
        out = capsys.readouterr().out
        assert ("MODEL WARN" in out) is warn
        assert warn or "model residual" in out


TRIAL = """
import sys
from dampr_tpu_torch import Dampr
em = (Dampr.memory([(i % 50, 1) for i in range(3000)])
      .fold_by(lambda kv: kv[0], lambda a, b: a + b, lambda kv: kv[1])
      .sink_tsv(sys.argv[1]).run("tune-sub"))
em.delete()
"""


class TestSubprocessSession:
    def test_vector_reaches_the_trial(self, isolated):
        """Trial 1 runs under ``as_env`` of its vector: the corpus record
        its run appended shows the knob at the trial's value."""
        out = str(isolated / "out")
        env = dict(os.environ, DAMPR_TPU_TORCH_DEVICE="cpu",
                   DAMPR_TPU_TORCH_SCRATCH=settings.scratch_root,
                   PYTHONPATH=ROOT)
        report = autotune.session(
            [sys.executable, "-c", TRIAL, out], "tune-sub", trials=2,
            assert_dir=out, base_env=env, out=lambda m: None)
        a = report["autotune"]
        assert [t["returncode"] for t in a["trials"]] == [0, 0]
        assert a["byte_identical"] is True
        knobs = a["trials"][1]["knobs"]
        assert knobs == {"overlap_windows": 0}
        recs = history.load("tune-sub")
        assert len(recs) == 2
        assert recs[0]["settings"]["overlap_windows"] == 2
        assert recs[1]["settings"]["overlap_windows"] == 0
        assert validate_doctor.validate(report, DOCTOR_SCHEMA,
                                        check_settings=False) == []


# -- C3: the variables the port's cost choices name are read --------------

C3_VALUES = {"merge_fanin": 77, "overlap_windows": 5,
             "spill_write_threads": 3, "spill_read_prefetch": 6,
             "spill_codec": "zlib", "exchange_hbm_budget": 1 << 25,
             "exchange_chunk_bytes": 4096}

PROBE = """
import json, sys
import dampr_tpu.settings as ref
from dampr_tpu_torch.obs import history
knob = sys.argv[1]
print(json.dumps([history.knob_value(knob), getattr(ref, knob)]))
"""


@pytest.fixture(scope="module")
def probes():
    """One fresh process per knob, all started at once, each with the
    port's variable and the JAX package's set to the knob's value."""
    procs = {}
    for knob, value in C3_VALUES.items():
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
        env[model.ENV_OF[knob]] = str(value)
        env[ref_model.ENV_OF[knob]] = str(value)
        procs[knob] = subprocess.Popen(
            [sys.executable, "-c", PROBE, knob], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for knob, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr
        out[knob] = json.loads(stdout.strip().splitlines()[-1])
    return out


class TestC3:
    def test_every_env_knob_is_probed(self):
        assert {k for k, v in model.ENV_OF.items() if v} == set(C3_VALUES)
        for knob in C3_VALUES:
            assert model.ENV_OF[knob].startswith("DAMPR_TPU_TORCH_")

    @pytest.mark.parametrize("knob", sorted(C3_VALUES))
    def test_variable_sets_the_knob(self, probes, knob):
        port_value, ref_value = probes[knob]
        assert port_value == C3_VALUES[knob]
        assert ref_value == port_value

    def test_a_cost_choice_names_the_ports_variable(self):
        recs = []
        for i, (ow, mbps) in enumerate([(2, 10.0), (2, 11.0), (4, 30.0),
                                        (4, 31.0), (2, 10.5)]):
            recs.append({"schema": history.SCHEMA, "run": "r",
                         "fingerprint": "fp", "ts": float(i),
                         "stage_shapes": [], "stages": [],
                         "throughput": {"mbps": mbps},
                         "settings": {"overlap_windows": ow}})
        m = model.build(recs, "fp")
        choices = model.search_variance_knobs(
            m, {k: history.knob_value(k) for k in model.VARIANCE_KNOBS})
        picked = [c for c in choices if c.get("env")]
        assert picked and all(c["env"] == model.ENV_OF[c["knob"]]
                              for c in picked)
