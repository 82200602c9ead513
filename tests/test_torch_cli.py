"""The command-line tools of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_metrics.py::TestStatsCli`` and of the
``cli.py`` entry points: ``python -m dampr_tpu_torch.cli stats`` with
``--series``, ``--prom`` and ``--log`` on a traced port run; exit 3 for a
run that left a crashdump; ``--fleet`` on a one-process run prints the
JAX package's "no fleet section" line, and a coordinator in the
environment without the rank's id and count exits 2.  On
the same ``trace.json`` and ``stats.json``, ``export.load_series``,
``format_series``, ``format_pipeline_series`` and ``critpath.from_run``
give the JAX functions' results.  ``wc``, ``tfidf`` and ``lint`` run
through the dispatcher on the CPU against Counter oracles.
"""

import collections
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from dampr_tpu.obs import critpath as ref_critpath
from dampr_tpu.obs import export as ref_export
from dampr_tpu_torch import Dampr, cli, settings
from dampr_tpu_torch.obs import critpath, export

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def traced(tmp_path):
    names = ("device", "trace", "trace_dir", "scratch_root",
             "metrics_interval_ms")
    old = {n: getattr(settings, n) for n in names}
    settings.device = "cpu"
    settings.trace = True
    settings.trace_dir = str(tmp_path / "traces")
    settings.scratch_root = str(tmp_path / "scratch")
    settings.metrics_interval_ms = 10
    yield tmp_path
    for n, v in old.items():
        setattr(settings, n, v)


def _run(name, n=20000):
    em = (Dampr.memory(list(range(n)), partitions=4)
          .map(lambda x: (x % 97, x))
          .fold_by(lambda kv: kv[0], lambda a, b: a + b, lambda kv: kv[1])
          .run(name=name))
    stats = em.stats()
    em.delete()
    return stats


class TestStats:
    def test_plain_and_json(self, traced, capsys):
        stats = _run("cli-plain")
        assert cli.main(["stats", "cli-plain"]) == 0
        out = capsys.readouterr().out
        assert out.startswith("stats: {}".format(stats["stats_file"]))
        assert "bottleneck:" in out
        assert cli.main(["stats", stats["stats_file"], "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["run"] == "cli-plain"

    def test_series_prom_log(self, traced, capsys):
        stats = _run("cli-series")
        assert cli.main(["stats", "cli-series", "--series", "--prom",
                         "--log"]) == 0
        out = capsys.readouterr().out
        assert "# TYPE dampr_tpu_store_records_total counter" in out
        series = export.format_series(export.load_series(
            stats["trace_file"]))
        assert series in out and "store.resident_bytes" in series
        # as in the JAX CLI, --prom keeps the log tail off stdout
        assert "[run-finish]" not in out
        assert cli.main(["stats", "cli-series", "--series", "--log"]) == 0
        out = capsys.readouterr().out
        assert series in out and "[run-finish]" in out

    def test_log_tail_in_json(self, traced, capsys):
        _run("cli-log")
        assert cli.main(["stats", "cli-log", "--log", "2", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert [r["code"] for r in doc["log_tail"]][-1] == "run-finish"

    def test_missing_run_exits_two(self, traced, capsys):
        assert cli.main(["stats", "nonesuch"]) == 2
        assert "no stats.json" in capsys.readouterr().err

    def test_crashdump_exits_three(self, traced, capsys):
        def boom(x):
            if x == 333:
                raise RuntimeError("injected")
            return (x, x)

        with pytest.raises(RuntimeError, match="injected"):
            Dampr.memory(list(range(2000))).map(boom).run(name="cli-dead")
        assert cli.main(["stats", "cli-dead"]) == 3
        err = capsys.readouterr().err
        assert "CRASHED RUN" in err and "RuntimeError" in err

    def test_fleet_refused(self, traced, capsys):
        """A one-process run has no fleet to merge: the section stays
        absent and the text says so (the multi-process merge is
        ``test_torch_fleet_mp.py``'s)."""
        _run("cli-fleet")
        assert cli.main(["stats", "cli-fleet", "--fleet"]) == 0
        assert "no fleet section: single-process run" in (
            capsys.readouterr().out)


class TestAgainstJax:
    def test_series_functions_equal(self, traced):
        stats = _run("cli-eq")
        tf = stats["trace_file"]
        series = export.load_series(tf)
        assert series and series == ref_export.load_series(tf)
        assert export.format_series(series) == ref_export.format_series(
            series)
        for vals in ([], [1.0], [3, 3, 3], list(range(100)),
                     np.random.RandomState(3).rand(57).tolist()):
            assert export._sparkline(vals) == ref_export._sparkline(vals)

    def test_pipeline_series_equal(self, traced):
        with open(_run("cli-pipe")["stats_file"]) as f:
            summary = json.load(f)
        synthetic = dict(summary, pipeline={
            "queue_depth_series": [[1, 0.1, 100], [1, 0.2, 5000],
                                   [2, 0.1, 7], [1, 0.3, 0]],
            "executed": 2, "degraded": 0, "overlap_seconds": 0.5,
            "overlap_fraction": 0.25, "stall_seconds": 0.01,
            "queue_peak_bytes": 5000},
            overlap={"windows": 2, "stall_fraction": 0.125})
        for s in (summary, synthetic, {}):
            assert export.format_pipeline_series(s) == \
                ref_export.format_pipeline_series(s)
        assert "stage 1" in export.format_pipeline_series(synthetic)

    def test_critpath_from_run_equal(self, traced):
        stats = _run("cli-crit")
        for run in (stats["stats_file"], os.path.dirname(
                stats["stats_file"]), "cli-crit"):
            assert critpath.from_run(run) == ref_critpath.from_run(
                stats["stats_file"])

    def test_no_samples_message_names_the_ports_variable(self):
        assert "DAMPR_TPU_TORCH_METRICS_MS" in export.format_series({})


class TestDispatch:
    def test_unknown_command(self, capsys):
        assert cli.main(["nonesuch"]) == 2
        assert cli.main([]) == 2
        assert "usage" in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [["bench"], ["wc", "x"],
                                      ["tfidf", "x"]])
    def test_coordinator_refused(self, monkeypatch, capsys, argv):
        """A coordinator without the rank's id and count is an incomplete
        deployment: exit 2, never a silent run as one process."""
        monkeypatch.setenv(cli.COORDINATOR_ENV, "localhost:1234")
        monkeypatch.delenv("DAMPR_TPU_TORCH_NUM_PROCESSES", raising=False)
        monkeypatch.delenv("DAMPR_TPU_TORCH_PROCESS_ID", raising=False)
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2
        assert "DAMPR_TPU_TORCH_NUM_PROCESSES" in capsys.readouterr().err

    def test_module_entry_point(self, tmp_path):
        env = dict(os.environ, DAMPR_TPU_TORCH_SCRATCH=str(tmp_path),
                   DAMPR_TPU_TORCH_DEVICE="cpu")
        p = subprocess.run([sys.executable, "-m", "dampr_tpu_torch.cli",
                            "stats", "nonesuch", "--fleet"], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=120)
        assert p.returncode == 2 and "no stats.json found" in p.stderr


def _text(tmp_path, seed=9):
    """Words with distinct counts (the top 20 has no ties)."""
    rng = np.random.RandomState(seed)
    words = []
    for i in range(40):
        words += ["w{}".format(i)] * (i * 3 + 1)
    rng.shuffle(words)
    path = tmp_path / "words.txt"
    with open(path, "w") as f:
        for i in range(0, len(words), 7):
            f.write(" ".join(words[i:i + 7]) + "\n")
    return str(path), words


class TestWorkloads:
    def test_wc(self, traced, capsys):
        path, words = _text(traced)
        assert cli.main(["wc", path, "--stats"]) == 0
        out = capsys.readouterr().out.splitlines()
        want = ["{}: {}".format(w, c) for w, c in
                collections.Counter(words).most_common(20)]
        assert out[:20] == want
        assert any(line.startswith("run: wc-cli") for line in out)

    def test_wc_explain_runs_nothing(self, traced, capsys):
        path, _ = _text(traced)
        assert cli.main(["wc", path, "--explain"]) == 0
        assert "wc-cli" in capsys.readouterr().out

    def test_tfidf(self, traced, capsys):
        path, _ = _text(traced)
        out_dir = str(traced / "idf")
        assert cli.main(["tfidf", path, "--out", out_dir]) == 0
        assert "TSV parts in" in capsys.readouterr().out
        with open(path) as f:
            lines = f.read().splitlines()
        df = collections.Counter(w for ln in lines for w in set(ln.split()))
        got = sorted(ln for part in os.listdir(out_dir)
                     for ln in open(os.path.join(out_dir, part))
                     .read().splitlines())
        assert got == sorted("{}\t{}\t{}".format(
            w, c, math.log(1 + float(len(lines)) / c))
            for w, c in df.items())

    def test_lint_bench_module(self, capsys):
        assert cli.main(["lint", "dampr_tpu_torch.bench_tfidf",
                         "--json"]) == 0
        report = json.loads(capsys.readouterr().out)
        assert report["targets"] and report["counts"]["error"] == 0
