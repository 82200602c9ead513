"""The TF-IDF benchmark of dampr_tpu_torch against dampr_tpu's.

``python -m dampr_tpu_torch.cli bench`` at ``DAMPR_BENCH_MB=1`` on the
CPU: it prints one JSON line with the JAX bench line's key set (read from
the JAX source's ``record`` literal), which ``tools/check_bench.py``
accepts; the bench's own exact check against the single-core baseline
passes; its sink equals, line for line once sorted, the JAX
``run_dampr_tpu``'s on the same corpus (the generator is the JAX one,
seed and all).  With autotune on, the line carries the session, every
trial byte-identical.
"""

import ast
import importlib.util
import inspect
import json
import os

import pytest

from dampr_tpu import bench_tfidf as ref_bench
from dampr_tpu import settings as ref_settings
from dampr_tpu_torch import bench_tfidf, cli, settings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


check_bench = _load_tool("check_bench")


def _jax_line_keys():
    """The keys of the JAX bench's JSON line: its ``record`` dict literal
    plus the ``autotune`` section it adds under autotune."""
    tree = ast.parse(inspect.getsource(ref_bench.main).lstrip())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "record"):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record literal in the JAX bench")


@pytest.fixture
def bench(tmp_path, monkeypatch):
    names = ("device", "scratch_root", "trace", "trace_dir", "autotune",
             "autotune_trials")
    old = {n: getattr(settings, n) for n in names}
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    monkeypatch.setattr(bench_tfidf, "BENCH_DIR", str(tmp_path / "bench"))
    monkeypatch.setattr(bench_tfidf, "BENCH_MB", 1)
    yield tmp_path
    for n, v in old.items():
        setattr(settings, n, v)


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


def _sorted_lines(d):
    lines = []
    for part in sorted(os.listdir(d)):
        with open(os.path.join(d, part)) as f:
            lines.extend(f.read().splitlines())
    return sorted(lines)


class TestBench:
    def test_line_keys_and_check_bench(self, bench, capsys):
        assert cli.main(["bench"]) == 0
        rec = _line(capsys)
        assert set(rec) == _jax_line_keys()
        assert rec["metric"] == "tfidf_docfreq_throughput"
        assert rec["unit"] == "MB/s" and rec["value"] > 0
        assert rec["vs_baseline"] > 0
        fresh = bench / "fresh.json"
        fresh.write_text(json.dumps(rec))
        assert check_bench.main([str(fresh)]) == 0
        # and as a baseline of itself, strictly
        assert check_bench.main([str(fresh), "--baseline", str(fresh),
                                 "--strict"]) == 0

    def test_sink_equals_the_jax_bench(self, bench, capsys):
        assert cli.main(["bench"]) == 0
        capsys.readouterr()
        corpus = os.path.join(bench_tfidf.BENCH_DIR, "corpus_1mb.txt")
        port_lines = _sorted_lines(os.path.join(bench_tfidf.BENCH_DIR,
                                                "dampr-idf"))
        old = ref_settings.scratch_root
        ref_settings.scratch_root = str(bench / "ref-scratch")
        try:
            ref_bench.make_corpus(str(bench / "ref" / "c.txt"), 1)
            ref_out = str(bench / "ref" / "idf")
            ref_bench.run_dampr_tpu(corpus, ref_out)
        finally:
            ref_settings.scratch_root = old
        with open(corpus, "rb") as a, open(str(bench / "ref" / "c.txt"),
                                           "rb") as b:
            assert a.read() == b.read()  # the same generator and seed
        assert port_lines == _sorted_lines(ref_out)
        assert len(port_lines) > 10000

    def test_autotune_line(self, bench, capsys):
        settings.autotune = "on"
        settings.autotune_trials = 2
        settings.trace = True
        bench_tfidf.main()
        rec = _line(capsys)
        assert set(rec) == _jax_line_keys() | {"autotune"}
        a = rec["autotune"]
        assert a["byte_identical"] is True and len(a["trials"]) == 2
        # the line's artifacts are the winning trial's own
        assert "trial-{}".format(a["winner"]["trial"]) in rec["stats_file"]
        with open(rec["stats_file"]) as f:
            assert json.load(f)["run"] == bench_tfidf.RUN_NAME
        fresh = bench / "fresh.json"
        fresh.write_text(json.dumps(rec))
        assert check_bench.main([str(fresh)]) == 0

    def test_defaults(self):
        assert bench_tfidf.RX.pattern == ref_bench.RX.pattern
        if "DAMPR_BENCH_MB" not in os.environ:
            assert bench_tfidf.BENCH_MB == 128 == ref_bench.BENCH_MB

    def test_cuda_without_a_card_raises(self, bench, monkeypatch):
        import torch

        if torch.cuda.is_available():
            pytest.skip("a card is visible")
        settings.device = "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            bench_tfidf.main()

    def test_lint_hook(self):
        (name, pipe), = bench_tfidf.lint_pipelines()
        assert name == "bench_tfidf" and pipe is not None
