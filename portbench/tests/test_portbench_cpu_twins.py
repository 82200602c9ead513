"""The on-CPU twins of the host metrics, through the CPU ``run(...,
device=...)`` path over the tiny traffic: a traced run of each cell
reports every new metric its cell lists in ``BENCHMARK.json``, each twin
reads at most its wall metric (they read the same sites), and the
off-CPU share is a share."""

import json
import os

import pytest

from portbench import run
from portbench.tests.conftest import ROOT

#: Each twin and the wall metric it splits.
TWINS = {"sink.cpu_ms_per_mb": "sink.host_ms_per_mb",
         "handoff.absorb_cpu_ms_per_mb": "handoff.absorb_ms_per_mb",
         "record_ops.cpu_ms_per_mb": "record_ops.ms_per_mb",
         "keyed.cpu_ms_per_mb": "keyed.host_ms_per_mb"}

NEW = ("host.offcpu_pct",) + tuple(TWINS)


def _listed(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    return {m["name"] for m in doc["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}


@pytest.mark.parametrize("tiny,cell", [("tfidf-tiny", "tfidf-20x"),
                                       ("wc-tiny", "wc-1x"),
                                       ("tfidf-tiny-bgzf", "tfidf-bgzf-20x")])
def test_traced_run_reports_the_twins(tiny_root, port_settings, monkeypatch,
                                      tiny, cell):
    # the tiny corpus's keyed blocks are under the CPU's device floor
    monkeypatch.setattr(port_settings, "_MIN_BATCH_FLOOR", 256)
    r = run.run(["--workload", tiny, "--seed", str(2 ** 31 + 7),
                 "--seconds", "0.5", "--trace", "1"],
                root=tiny_root, device="cpu")
    assert r["correct"] is True
    m = {k: v["value"] for k, v in r["metrics"].items()}
    listed = _listed(cell)
    assert listed and listed <= set(m), (listed, sorted(m))
    for twin, wall in TWINS.items():
        if twin in listed:
            assert 0 <= m[twin] <= m[wall] * 1.01, (twin, m[twin], m[wall])
    assert 0 <= m["host.offcpu_pct"] <= 100
