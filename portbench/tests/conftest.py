"""Fixtures of the benchmark's own tests: a small copy of the benchmark
(the real configurations, pipelines, references, makers and readers over
a 40 KB base, plain and BGZF) run on the CPU through the lowered path's
plain versions."""

import json
import os
import shutil
import tempfile

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)

#: A 40,500-byte base of 499 distinct words, two copies to a corpus.
TINY_BASE = {
    "bytes": 40500,
    "word_lengths": {"1": 2, "2": 20, "3": 60, "4": 100, "5": 100, "6": 80,
                     "7": 60, "8": 40, "9": 20, "10": 10, "12": 4, "17": 2,
                     "20": 1},
    "zipf": {"a": 10000, "s": 1.4, "q": 12},
}


def tiny_traffic(factor=2):
    with open(os.path.join(PKG, "traffic", "shakespeare-1x.json")) as f:
        base = json.load(f)["base"]
    base = dict(base, **TINY_BASE)
    return {"about": "a test-sized base", "maker": "shakespeare",
            "factor": factor, "base": base}


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout-like root holding a copy of ``portbench/`` and a
    ``BENCHMARK.json`` whose cells run the real configurations over the
    tiny traffic; ``TMPDIR`` under ``tmp_path``."""
    root = tmp_path / "root"
    shutil.copytree(PKG, str(root / "portbench"),
                    ignore=shutil.ignore_patterns("tests", "_cache",
                                                  "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    with open(str(root / "portbench" / "traffic" / "tiny-2x.json"),
              "w") as f:
        json.dump(tiny_traffic(), f)
    # 6 copies, the base named: 243,000 bytes of text in 4 members
    with open(str(root / "portbench" / "traffic" / "tiny-6x-bgzf.json"),
              "w") as f:
        json.dump({"about": "the tiny base, stored BGZF",
                   "maker": "shakespeare", "factor": 6,
                   "storage": "bgzf", "base": "tiny-2x"}, f)
    doc["workloads"] = [
        {"name": "tfidf-tiny", "config": "tfidf-shakespeare",
         "traffic": "tiny-2x", "chips": 1, "why": "test"},
        {"name": "wc-tiny", "config": "wordcount-shakespeare",
         "traffic": "tiny-2x", "chips": 1, "why": "test"},
        {"name": "tfidf-tiny-bgzf", "config": "tfidf-shakespeare",
         "traffic": "tiny-6x-bgzf", "chips": 1, "why": "test"}]
    for m in doc["per_layer"]:
        m.pop("workloads", None)
    with open(str(root / "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setenv("TMPDIR", str(tmp))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    return str(root)


@pytest.fixture
def port_settings():
    """Restore every setting a run pins."""
    from dampr_tpu_torch import settings

    saved = dict(vars(settings))
    yield settings
    for k, v in saved.items():
        setattr(settings, k, v)
