"""The harness finds cells, configurations, traffic and metrics by name,
so that a later change adds them as files."""

import json
import os
import shutil

import pytest

from portbench import registry, run
from portbench.tests.conftest import ROOT


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_named_file_exists():
    doc = _bench()
    here = registry.HERE
    for c in doc["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert os.path.isfile(os.path.join(here, "pipelines",
                                           c["name"] + ".py"))
        assert os.path.isfile(os.path.join(here, "reference",
                                           c["name"] + ".py"))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg["settings"] or key in cfg, key
    for w in doc["workloads"]:
        assert os.path.isfile(os.path.join(here, "traffic",
                                           w["traffic"] + ".json"))
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert os.path.isfile(os.path.join(here, "metrics",
                                           m["name"] + ".py"))


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_readers_agree_with_the_benchmark(kind):
    for m in _bench()[kind]:
        mod = registry.load_module("metrics", m["name"])
        assert mod.UNIT == m["unit"], m["name"]
        assert mod.BETTER == m["better"], m["name"]
        if kind == "per_layer":
            assert mod.LAYER == m["layer"], m["name"]
            assert mod.MOVES == m["moves"], m["name"]


def test_cell_metrics_follow_their_workloads_key():
    bench = registry.Bench()
    names = [m["name"] for m in bench.metrics("wc-1x", trace=1)]
    assert "record_ops.ms_per_mb" in names
    assert "kernels_roofline" not in names
    assert [m["name"] for m in bench.metrics("wc-1x", trace=0)] == [
        "host_mem_peak_mb", "setup_s"]


def test_added_files_are_found(tiny_root, port_settings):
    """A configuration, a traffic mix and a metric, each added as files and
    entries only, run as a new cell."""
    pb = os.path.join(tiny_root, "portbench")
    for kind, ext in (("configs", ".json"), ("pipelines", ".py"),
                      ("reference", ".py")):
        shutil.copy(os.path.join(pb, kind, "wordcount-shakespeare" + ext),
                    os.path.join(pb, kind, "wc-again" + ext))
    cfg = os.path.join(pb, "configs", "wc-again.json")
    with open(cfg) as f:
        doc = json.load(f)
    doc["name"] = "wc-again"
    doc["chunks"] = 3
    doc["settings"]["max_processes"] = 2
    with open(cfg, "w") as f:
        json.dump(doc, f)
    shutil.copy(os.path.join(pb, "traffic", "tiny-2x.json"),
                os.path.join(pb, "traffic", "tiny-again.json"))
    with open(os.path.join(pb, "metrics", "jobs_in_window.py"), "w") as f:
        f.write("LAYER = 'runner'\nUNIT = 'count'\nBETTER = 'higher'\n"
                "MOVES = 'host_mem_peak_mb'\n\n\ndef read(ctx):\n"
                "    return len(ctx.jobs)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "wc-again", "source": "test",
                             "file": "portbench/configs/wc-again.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "again", "config": "wc-again",
                               "traffic": "tiny-again", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "jobs_in_window", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "runner", "moves": "host_mem_peak_mb",
                               "workloads": ["again"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    r = run.run(["--workload", "again", "--seed", "9", "--seconds", "0.3",
                 "--trace", "1"], root=tiny_root, device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["jobs_in_window"]["value"] == r["attempted"]
