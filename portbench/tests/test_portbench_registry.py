"""The harness finds cells, configurations, traffic and metrics by name,
so that a later change adds them as files."""

import json
import os
import shutil

import pytest

from portbench import control, registry, run
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


#: A maker of two seeded tables, a join over them and its reference: what
#: a join configuration brings, as files only.
TOY_MAKER = '''
import os

from portbench import corpus


def make(traffic, seed, work_dir, bench):
    rng = corpus._seed_rng(seed)
    n = int(traffic["pages"])
    ranks = [("u%d" % i, int(r)) for i, r in
             enumerate(rng.integers(0, 100, n))]
    visits = [("u%d" % int(u), int(c)) for u, c in
              zip(rng.integers(0, 2 * n, traffic["visits"]),
                  rng.integers(0, 10 ** 7, traffic["visits"]))]
    paths = {}
    for name, rows in (("rankings", ranks), ("visits", visits)):
        paths[name] = os.path.join(work_dir, name + ".tsv")
        with open(paths[name], "w") as f:
            f.writelines("%s\\t%d\\n" % row for row in rows)
    size = sum(os.path.getsize(p) for p in paths.values())
    return {"input": paths, "bytes": size, "stored_bytes": size,
            "truth": (ranks, visits), "about": {"pages": n}}
'''

TOY_PIPELINE = '''
def _row(line):
    key, value = line.split("\\t")
    return key, int(value)


def job(inputs, chunk_size, out_dir):
    from dampr_tpu_torch import Dampr

    ranks = (Dampr.text(inputs["rankings"], chunk_size).map(_row)
             .group_by(lambda r: r[0], lambda r: r[1]))
    visits = (Dampr.text(inputs["visits"], chunk_size).map(_row)
              .group_by(lambda r: r[0], lambda r: r[1]))
    em = ranks.join(visits).reduce(lambda rs, vs: (max(rs), sum(vs))).run()
    records = list(em.read())
    em.delete()
    return records, em.stats()
'''

TOY_REFERENCE = '''
import numpy as np


def _join(ranks, visits, add):
    rank = dict(ranks)
    out = {}
    for url, cents in visits:
        if url in rank:
            out[url] = (rank[url], add(out.get(url, (0, 0))[1], cents))
    return out


def expected(ranks, visits):
    return _join(ranks, visits, lambda a, b: a + b)


def control(ranks, visits):
    return _join(ranks, visits,
                 lambda a, b: int(np.float32(a) + np.float32(b)))


def load(output):
    return dict(output)


def work(ranks, visits):
    return {"bytes": 0}
'''


def test_two_input_maker_runs_as_files_only(tiny_root, port_settings):
    """A data shape of two tables, a join over them and its reference,
    added as a maker, a traffic file, a configuration, a pipeline and a
    reference, run through the harness as a new cell whose control
    fails."""
    pb = os.path.join(tiny_root, "portbench")
    for kind, text in (("makers", TOY_MAKER), ("pipelines", TOY_PIPELINE),
                       ("reference", TOY_REFERENCE)):
        with open(os.path.join(pb, kind, "toy-join.py"), "w") as f:
            f.write(text)
    with open(os.path.join(pb, "traffic", "toy-tables.json"), "w") as f:
        json.dump({"maker": "toy-join", "pages": 300, "visits": 2000}, f)
    with open(os.path.join(pb, "configs",
                           "wordcount-shakespeare.json")) as f:
        cfg = json.load(f)
    cfg.update(name="toy-join", chunks=3, check_jobs="all")
    with open(os.path.join(pb, "configs", "toy-join.json"), "w") as f:
        json.dump(cfg, f)
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy-join", "source": "test",
                             "file": "portbench/configs/toy-join.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "toy", "config": "toy-join",
                               "traffic": "toy-tables", "chips": 1,
                               "why": "test"})
    with open(path, "w") as f:
        json.dump(bench, f)
    r = run.run(["--workload", "toy", "--seed", str(2 ** 31 + 5),
                 "--seconds", "0.3", "--trace", "0"], root=tiny_root,
                device="cpu")
    assert r["correct"] is True and r["attempted"] >= 1
    assert r["checks"]["missing_rows"]["value"] == 0
    readings = control.readings(registry.Bench(tiny_root), "toy",
                                2 ** 31 + 5)
    assert readings["wrong_rows"] > 0
