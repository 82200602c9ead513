"""Whole runs of the harness on the CPU (no look for a card), over the
tiny traffic: the last line's keys, the comparison, the faults it has to
catch, and the modules a run leaves loaded."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from portbench import control, registry, run
from portbench.tests.conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(root, workload, trace=0, seed=2 ** 31 + 3):
    return run.run(["--workload", workload, "--seed", str(seed),
                    "--seconds", "0.5", "--trace", str(trace)],
                   root=root, device="cpu")


@pytest.mark.parametrize("workload", ["tfidf-tiny", "wc-tiny",
                                      "tfidf-tiny-bgzf"])
def test_sound_run_is_correct(tiny_root, port_settings, workload):
    r = _run(tiny_root, workload)
    assert list(r) == KEYS
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] >= 1
    assert set(r["metrics"]) == {"host_mem_peak_mb", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["checks"] == {k: {"value": 0, "limit": 0} for k in
                           ("missing_rows", "extra_rows", "wrong_rows")}


def test_run_file_holds_each_jobs_wall_and_plan(tiny_root, port_settings,
                                                tmp_path):
    """The run's file keeps every job's wall and plan, and the corpus's
    making apart from ``setup_s``; the run takes no option that would
    change the configuration it runs."""
    path = str(tmp_path / "run.json")
    r = run.run(["--workload", "wc-tiny", "--seed", "4", "--seconds", "0.3",
                 "--trace", "0", "--run-file", path], root=tiny_root,
                device="cpu")
    assert r["correct"] is True
    with open(path) as f:
        doc = json.load(f)
    assert [j["wall"] > 0 for j in doc["jobs"]] == [True] * r["attempted"]
    assert len(doc["warmup"]) == run.WARMUP_JOBS
    plans = [j["plan"] for j in doc["warmup"] + doc["jobs"]]
    assert plans == [plans[0]] * len(plans)
    steps = {s["step"]: s["s"] for s in doc["setup_steps"]}
    assert 0 < doc["corpus_s"] <= steps["corpus"]
    assert doc["setup_s"] == r["metrics"]["setup_s"]["value"]
    assert doc["setup_s"] < steps["warm-up job 0"] + 1.0
    with pytest.raises(SystemExit):
        run.run(["--workload", "wc-tiny", "--seed", "4", "--seconds", "0.3",
                 "--trace", "0", "--set", "max_processes=2"],
                root=tiny_root, device="cpu")


def test_run_file_holds_the_data_it_ran(tiny_root, port_settings,
                                       tmp_path):
    """The run's file names the data: its text and stored bytes, the
    chunk size cut from the stored size, its SHA-256 and what the maker
    says of it (the BGZF members)."""
    path = str(tmp_path / "run.json")
    r = run.run(["--workload", "tfidf-tiny-bgzf", "--seed", "4",
                 "--seconds", "0.3", "--trace", "0", "--run-file", path],
                root=tiny_root, device="cpu")
    assert r["correct"] is True
    with open(path) as f:
        doc = json.load(f)
    assert doc["corpus_bytes"] == 6 * 40500
    assert 0 < doc["stored_bytes"] < doc["corpus_bytes"]
    assert doc["chunk_size"] == -(-doc["stored_bytes"] // 8)
    assert doc["corpus_about"]["members"] == 4
    assert doc["corpus_about"]["storage"] == "bgzf"
    assert len(doc["corpus_sha256"]["input"]) == 64
    assert 0 < doc["maker_s"] <= doc["corpus_s"]


def test_traced_run_reports_per_layer(tiny_root, port_settings):
    r = _run(tiny_root, "tfidf-tiny", trace=1)
    assert r["correct"] is True
    m = r["metrics"]
    # the timeline's metrics need a card; the program's are read here
    assert "kernels_roofline" not in m and "device.idle_pct" not in m
    for name in ("cold_job_s", "pipeline.corpus_mb_s", "plan.lowered_stages",
                 "runner.map_ms_per_mb", "sink.host_ms_per_mb",
                 "handoff.absorb_ms_per_mb"):
        assert name in m, name
    assert m["plan.lowered_stages"]["value"] >= 1
    w = _run(tiny_root, "wc-tiny", trace=1)
    assert w["metrics"]["record_ops.ms_per_mb"]["value"] > 0


# -- the faults: the timed path broken underneath, correct must be false --

def _bump_first_total(monkeypatch):
    """One count off by one where the fold produces it: in the token fold
    (before the vocabulary table exists) and in the table program."""
    from dampr_tpu_torch.ops import handoff, segfold

    fold = segfold.segfold_gather_reference
    probe = handoff.table_probe_reference

    def broken_fold(*a, **k):
        out = list(fold(*a, **k))
        tot, live = out[2], out[3]
        idx = np.flatnonzero(live.numpy())
        if len(idx):
            tot[int(idx[0])] += 1
        return tuple(out)

    def broken_probe(*a, **k):
        out = probe(*a, **k)
        acc = a[7]
        idx = np.flatnonzero(acc[:-1].numpy())
        if len(idx):
            acc[int(idx[0])] += 1
        return out
    monkeypatch.setattr(segfold, "segfold_gather_reference", broken_fold)
    monkeypatch.setattr(handoff, "table_probe_reference", broken_probe)


def _bump_first_total_or_bootstrap(monkeypatch):
    """As :func:`_bump_first_total`, and where a whole chunk is one window
    (a BGZF chunk) and the CPU seeds each vocabulary from it through the
    host codec, one count off by one there too."""
    from dampr_tpu_torch.blocks import Block
    from dampr_tpu_torch.ops import lower

    _bump_first_total(monkeypatch)
    orig = lower.chunk_doc_freq

    def broken(*a, **k):
        out = orig(*a, **k)
        if out is not None and len(out):
            vals = np.array(out.values, copy=True)
            vals[0] += 1
            out = Block(out.keys, vals, out.h1, out.h2)
        return out
    monkeypatch.setattr(lower, "chunk_doc_freq", broken)


def _drop_half_the_tokens(monkeypatch):
    from dampr_tpu_torch.ops import lower

    orig = lower.DeviceTokenFoldSink._pad_rows

    def broken(self, buf, starts, lens, lines):
        mat, lens_t, lines_t = orig(self, buf, starts, lens, lines)
        lens_t[1::2] = 0  # every other token becomes a pad row
        return mat, lens_t, lines_t
    monkeypatch.setattr(lower.DeviceTokenFoldSink, "_pad_rows", broken)


def _drop_half_of_each_inflate(monkeypatch):
    """The compressed path's own fault: every member's inflate loses the
    second half of its bytes."""
    from dampr_tpu_torch.inputs import BgzfChunkDataset

    orig = BgzfChunkDataset._inflate

    def broken(raw):
        out = orig(raw)
        return out[:len(out) // 2]
    monkeypatch.setattr(BgzfChunkDataset, "_inflate", staticmethod(broken))


def _bump_first_count(monkeypatch):
    from dampr_tpu_torch.blocks import Block
    from dampr_tpu_torch.ops import segment

    orig = segment.fold_block

    def broken(block, op):
        out = orig(block, op)
        if len(out):
            vals = np.array(out.values, copy=True)
            vals[0] += 1
            out = Block(out.keys, vals, out.h1, out.h2)
        return out
    monkeypatch.setattr(segment, "fold_block", broken)


def _drop_half_the_batch(monkeypatch):
    from dampr_tpu_torch.ops import segment

    orig = segment.fold_block

    def broken(block, op):
        return orig(block.take(np.arange(0, len(block), 2)), op)
    monkeypatch.setattr(segment, "fold_block", broken)


@pytest.mark.parametrize("workload,fault", [
    ("tfidf-tiny", _bump_first_total),
    ("tfidf-tiny", _drop_half_the_tokens),
    ("wc-tiny", _bump_first_count),
    ("wc-tiny", _drop_half_the_batch),
    ("tfidf-tiny-bgzf", _bump_first_total_or_bootstrap),
    ("tfidf-tiny-bgzf", _drop_half_of_each_inflate),
], ids=["tfidf-answer-altered", "tfidf-half-the-batch",
        "wc-answer-altered", "wc-half-the-batch",
        "bgzf-answer-altered", "bgzf-half-of-each-inflate"])
def test_fault_is_not_correct(tiny_root, port_settings, monkeypatch,
                              workload, fault):
    fault(monkeypatch)
    r = _run(tiny_root, workload)
    assert r["correct"] is False
    assert sum(c["value"] for c in r["checks"].values()) > 0


def test_checked_jobs_are_a_fixed_seeded_sample():
    assert all(run.checked_jobs("all", 1)(i) for i in range(50))
    keep = run.checked_jobs(4, 2 ** 40 + 3)
    picked = [i for i in range(50) if keep(i)]
    assert len(picked) == 4 and max(picked) < 8
    assert picked == [i for i in range(50)
                      if run.checked_jobs(4, 2 ** 40 + 3)(i)]


@pytest.mark.parametrize("workload", ["tfidf-tiny", "wc-tiny",
                                      "tfidf-tiny-bgzf"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 11, 2 ** 33 + 1])
def test_control_is_not_correct(tiny_root, workload, seed):
    r = control.readings(registry.Bench(tiny_root), workload, seed)
    assert sum(r.values()) > 0


def test_run_leaves_no_jax_and_no_bench_module(tmp_path):
    """In a fresh process (this one may hold the JAX package), a run loads
    neither ``jax`` nor ``dampr_tpu`` (top-level names compared whole:
    ``dampr_tpu_torch`` starts with ``dampr_tpu``) nor the port's own
    bench module."""
    code = (
        "import sys, json, tempfile\n"
        "sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})\n"
        "tempfile.tempdir = {tmp!r}\n"
        "import conftest\n"
        "from portbench import run\n"
        "r = run.run(['--workload', 'wc-1x', '--seed', '7', '--seconds',"
        " '0.1', '--trace', '0'], device='cpu')\n"
        "print(json.dumps([r['correct'], run.forbidden_modules(),"
        " 'dampr_tpu_torch' in sys.modules,"
        " 'dampr_tpu_torch.bench_tfidf' in sys.modules]))\n").format(
            root=ROOT, tests=os.path.dirname(__file__), tmp=str(tmp_path))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        True, [], True, False]


def test_no_card_exits_nonzero_and_prints_nothing():
    """Here there is no card: the command refuses, with no result."""
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "wc-1x",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "cuda" in out.stderr.lower()


def test_bare_directory_exits_nonzero(tmp_path):
    """A directory holding only BENCHMARK.json and ``portbench/`` has no
    port to run."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), str(tmp_path))
    shutil.copytree(os.path.join(ROOT, "portbench"),
                    str(tmp_path / "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "wc-1x",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
        env=env)
    assert out.returncode != 0
    assert out.stdout == ""
