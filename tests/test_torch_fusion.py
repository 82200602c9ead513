"""The plan passes of dampr_tpu_torch against ``dampr_tpu.plan.passes``.

The same pipelines are built in both packages: ``examples/wc.py``,
``examples/word_stats.py`` (four outputs over a shared prefix), a
``checkpoint()`` barrier, a ``cached()`` pin, a ``sample()``, a shared
prefix, a dead branch and ``sink_tsv`` after a map.  Both packages'
``optimize`` must give the same executed stage counts before and after
and fire the same rules the same number of times.  Each pipeline must
read back the same records through the port with the plan passes run
and skipped and with the batched record path taken and not (the
per-record path), equal to the JAX package's
(records that tie on a ``sort_by`` key compared as multisets).  The
TF-IDF pipeline must still lower its DocFreq stage after fusion.
"""

import math
import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.plan import passes as ref_passes
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import text as port_text
from dampr_tpu_torch.plan import passes as port_passes

P = 8


@pytest.fixture(autouse=True)
def knobs():
    names = ("partitions", "device", "seed", "lower", "max_processes")
    old_port = {n: getattr(port_settings, n) for n in names}
    old_ref = (ref_settings.partitions, ref_settings.seed,
               ref_settings.max_processes)
    ref_settings.partitions = port_settings.partitions = P
    port_settings.device = "cpu"
    yield
    for n, v in old_port.items():
        setattr(port_settings, n, v)
    (ref_settings.partitions, ref_settings.seed,
     ref_settings.max_processes) = old_ref


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    rng = np.random.RandomState(11)
    words = ["w%d" % i for i in range(60)] + ["naïve", "日本語", "a"]
    path = str(tmp_path_factory.mktemp("fusion") / "c.txt")
    with open(path, "w", encoding="utf-8") as f:
        for _ in range(400):
            f.write(" ".join(rng.choice(words, rng.randint(0, 9))) + "\n")
    return path


def _word_stats(pkg, path):
    words = pkg.Dampr.text(path, 2000).flat_map(lambda line: line.split())
    top_words = (words.count(lambda x: x)
                 .sort_by(lambda word_count: -word_count[1]))
    total_count = top_words.fold_by(key=lambda word: 1,
                                    value=lambda x: x[1],
                                    binop=lambda x, y: x + y)
    word_lengths = (top_words
                    .fold_by(lambda tc: len(tc[0]), value=lambda tc: tc[1],
                             binop=lambda x, y: x + y)
                    .sort_by(lambda cl: cl[0]))
    avg_word_lengths = (word_lengths
                        .map(lambda wl: wl[0] * wl[1])
                        .a_group_by(lambda x: 1)
                        .sum()
                        .join(total_count)
                        .reduce(lambda awl, tc:
                                next(awl)[1] / float(next(tc)[1])))
    return total_count, top_words, word_lengths, avg_word_lengths


def _dead_branch(pkg, path):
    base = pkg.Dampr.memory(list(range(40)), partitions=4).map(
        lambda x: x * 2)
    live = base.filter(lambda x: x % 3 == 0)
    dead = base.map(lambda x: -x).count()
    graph = live.pmer.graph.union(dead.pmer.graph)
    return (pkg.PMap(live.source, pkg.Dampr(graph)),)


PIPELINES = {
    "wc": lambda pkg, path: ((pkg.Dampr.text(path, 2000)
                              .flat_map(lambda line: line.split())
                              .fold_by(lambda w: w, binop=lambda x, y: x + y,
                                       value=lambda w: 1)),),
    "word_stats": _word_stats,
    "checkpoint": lambda pkg, path: (
        pkg.Dampr.memory(list(range(50)), partitions=5)
        .map(lambda x: x + 1).checkpoint().filter(lambda x: x % 2 == 0)
        .map(lambda x: x * 10),),
    "cached": lambda pkg, path: (
        pkg.Dampr.memory(list(range(30)), partitions=3)
        .map(lambda x: x % 7).cached().map(lambda x: x + 1),),
    # (behind a map stage: tests/test_torch_sort_runs.py)
    "sample": lambda pkg, path: (
        pkg.Dampr.memory(list(range(200)), partitions=1)
        .sample(0.5).map(lambda x: x + 1).map(lambda x: x * 2),),
    "shared_prefix": lambda pkg, path: _shared_prefix(pkg),
    "dead_branch": _dead_branch,
    "tsv_after_map": lambda pkg, path: (
        pkg.Dampr.memory([("a", 1), ("b", 2), ("c", 3)] * 5)
        .map(lambda x: (x[0], x[1] * 2))
        .sink_tsv(os.path.join(os.path.dirname(path),
                               "tsv-" + pkg.__name__)),),
}


def _shared_prefix(pkg):
    words = pkg.Dampr.memory(["a b", "b c d", "a"] * 7, partitions=3) \
        .flat_map(lambda s: s.split())
    return (words.count(), words.map(len).filter(lambda n: n > 0).count())


def _graph(handles):
    graph = handles[0].pmer.graph
    for h in handles[1:]:
        graph = h.pmer.graph.union(graph)
    return graph, [h.source for h in handles]


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_same_rules_and_stage_counts(corpus, name):
    reports = []
    for pkg, passes in ((dampr_tpu, ref_passes),
                        (dampr_tpu_torch, port_passes)):
        graph, outputs = _graph(PIPELINES[name](pkg, corpus))
        _, report = passes.optimize(graph, outputs)
        reports.append((report["stages_before"], report["stages_after"],
                        report["rules"]))
    assert reports[1] == reports[0]
    assert sum(reports[1][2].values()) > 0


def test_optimize_is_idempotent_and_keeps_outputs(corpus):
    handles = _word_stats(dampr_tpu_torch, corpus)
    graph, outputs = _graph(handles)
    once, _ = port_passes.optimize(graph, outputs)
    twice, report = port_passes.optimize(once, outputs)
    assert twice is once and sum(report["rules"].values()) == 0
    produced = {s.output for s in once.stages}
    assert all(o in produced for o in outputs)


def _read(pkg, handles):
    return [em.read() for em in pkg.Dampr.run(*handles)]


def _same(got, want, name, optimize):
    if name == "tsv_after_map" and not optimize:
        # a sink reads back its part files in job order: unfused, its jobs
        # are the map stage's hash partitions
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        return
    if name != "word_stats":
        assert got == want
        return
    # top_words: records that tie on -count may come in another order (the
    # JAX package's tiny-fold fast path, not ported, leaves count()'s
    # output in hash order within a partition; tests/test_torch_wc.py)
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 1:
            assert [c for _w, c in g] == [c for _w, c in w]
            assert sorted(g) == sorted(w)
        else:
            assert g == w


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_results_equal_with_optimize_and_batching_on_and_off(
        corpus, name, monkeypatch):
    if name == "sample":
        # one job thread and one seed: the same random sequence each run
        ref_settings.seed = port_settings.seed = 5
        ref_settings.max_processes = port_settings.max_processes = 1
    want = _read(dampr_tpu, PIPELINES[name](dampr_tpu, corpus))
    for optimize in (True, False):
        for batch in (True, False):
            with monkeypatch.context() as m:
                if not optimize:
                    m.setattr(port_passes, "optimize", lambda graph, outputs:
                              (graph, port_passes.empty_report(graph)))
                if not batch:
                    m.setattr(dampr_tpu_torch.base, "record_op_chain",
                              lambda op: None)
                got = _read(dampr_tpu_torch,
                            PIPELINES[name](dampr_tpu_torch, corpus))
            _same(got, want, name, optimize)
    if name == "sample":
        assert 50 < len(want[0]) < 150


def test_wc_fuses_into_one_map_stage(corpus):
    em = PIPELINES["wc"](dampr_tpu_torch, corpus)[0].run()
    stats = em.stats()
    assert [s["op"] for s in stats["stages"]] == ["FlatMap . Rekey",
                                                  "AssocFoldReducer"]
    assert stats["plan"]["fused"][-1]["rule"] == "hoist_combiners"


def test_tfidf_still_lowers_after_fusion(corpus):
    """DocFreq keeps its device target; the TSV map fuses into the sink."""
    port_settings.lower = "on"
    docs = dampr_tpu_torch.Dampr.text(corpus, 2000)
    df = (docs.custom_mapper(port_text.DocFreq(mode="word", lower=True,
                                               pair_values=False))
          .fold_values(operator.add))
    idf = df.cross_right(docs.len(), lambda d, total: (
        d[0], d[1], math.log(1 + float(total) / d[1])), memory=True)
    out = os.path.join(os.path.dirname(corpus), "idf")
    stats = idf.sink_tsv(out).run().stats()
    assert stats["device"]["device_stages"] >= 1
    assert stats["plan"]["rules"]["fuse_sinks"] == 1
    assert stats["plan"]["rules"]["hoist_combiners"] >= 1
    targets = {d["kind"]: d["target"] for d in
               stats["plan"]["lowering"]["targets"] if d["kind"] == "map"
               and d["target"] == "device"}
    assert targets == {"map": "device"}
