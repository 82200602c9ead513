"""The adaptive plan of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_plan.py``'s
``test_history_drives_sizing_and_results_stable``,
``test_no_history_static_defaults``, ``test_explicit_partitions_pinned``,
``test_explain_does_not_execute_or_mutate`` and
``test_stats_plan_section_always_present`` (the port has no optimizer
switch: a failed run's summary carries the never-prepared report
instead), and ``tests/test_analyze.py::test_explain_renders_analysis_section``.

Added, each against the JAX package on one shared corpus (both packages'
scratch roots point at one directory, the corpus written by port runs):

- the ``adaptive``, ``cost`` and ``pipeline`` report sections, the
  adapted partition count and stage options, equal;
- ``explain()`` text equal line for line but for these lines, each for
  its reason: the shuffle lines (the port routes every redistribution
  over the host shuffle of one card, the JAX side renders its
  ``mesh_exchange="off"`` line), the reuse line (the port has no
  cross-run cache yet), and, with lowering forced on, the reasons of
  device targets and resident handoff edges (each package names its own
  device programs);
- ``handoff_analyze``'s priced branch on hand-written corpora;
- records equal the JAX package's however history cuts the map blocks
  (``batch_size`` 16 to 8,192; with lowering on, a certified chain's lane
  program dispatches the larger batches).

Every comparison is exact.
"""

import operator
import types
import uuid

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import plan as ref_plan
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import text as ref_text
from dampr_tpu.plan import lower as ref_lower
from dampr_tpu.plan import passes as ref_passes
from dampr_tpu_torch import Dampr, plan, settings
from dampr_tpu_torch.obs import history
from dampr_tpu_torch.ops import text as port_text
from dampr_tpu_torch.plan import graph_signature, lower, passes

_REF = ("scratch_root", "mesh_fold", "mesh_exchange", "lower", "handoff",
        "optimize", "plan_adapt", "cost_model", "pipeline")
_PORT = ("scratch_root", "device", "lower", "handoff", "plan_adapt",
         "cost_model", "pipeline", "trace", "trace_dir", "analyze")


@pytest.fixture(autouse=True)
def shared_root(tmp_path):
    """One scratch root for both packages; the JAX side on its
    single-device branches (no mesh fold or exchange)."""
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    old = {n: getattr(settings, n) for n in _PORT}
    settings.scratch_root = ref_settings.scratch_root = str(
        tmp_path / "scratch")
    settings.device = "cpu"
    ref_settings.mesh_fold = ref_settings.mesh_exchange = "off"
    ref_settings.optimize = True
    yield tmp_path
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old.items():
        setattr(settings, n, v)


# -- the ported tests of tests/test_plan.py ----------------------------------

class TestAdaptive:
    def test_history_drives_sizing_and_results_stable(self, tmp_path):
        name = "plan-adapt-{}".format(uuid.uuid4().hex)
        settings.trace = True
        settings.trace_dir = str(tmp_path)

        def pipe():
            return (Dampr.memory(list(range(2000)))
                    .map(lambda x: (x % 5, x))
                    .fold_by(lambda kv: kv[0], operator.add,
                             lambda kv: kv[1]))

        em1 = pipe().run(name=name)
        r1 = sorted(em1.read())
        em2 = pipe().run(name=name)
        r2 = sorted(em2.read())
        ad = em2.stats()["plan"]["adaptive"]
        assert ad["applied"] is True
        assert any(c["what"] == "n_partitions" for c in ad["changes"])
        assert r1 == r2
        em2.delete()

    def test_no_history_static_defaults(self):
        em = (Dampr.memory([1, 2, 3]).map(lambda x: x)
              .run(name="plan-no-history-{}".format(uuid.uuid4().hex)))
        ad = em.stats()["plan"]["adaptive"]
        assert ad["applied"] is False
        assert ad["reason"] in ("no-history", "disabled")
        em.delete()

    def test_explicit_partitions_pinned(self, tmp_path):
        from dampr_tpu_torch.runner import MTRunner

        settings.trace = True
        settings.trace_dir = str(tmp_path)
        pipe = (Dampr.memory(list(range(500)))
                .map(lambda x: (x % 3, x))
                .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))
        name = "plan-pin-{}".format(uuid.uuid4().hex)
        r1 = MTRunner(name, pipe.pmer.graph, n_partitions=7)
        r1.run([pipe.source])
        r2 = MTRunner(name, pipe.pmer.graph, n_partitions=7)
        r2.run([pipe.source])
        assert r2.n_partitions == 7, "explicit partition count retuned"
        assert r2.plan_report["adaptive"]["history"] is not None


class TestObservabilitySurface:
    def test_explain_does_not_execute_or_mutate(self):
        pipe = (Dampr.memory([1, 2, 3]).map(lambda x: x + 1)
                .map(lambda x: x * 2))
        before = graph_signature(pipe.pmer.graph)
        name = "explain-" + uuid.uuid4().hex
        text = pipe.explain(name=name)
        assert "optimized plan" in text
        assert graph_signature(pipe.pmer.graph) == before
        assert history.load(name) == []

    def test_stats_plan_section_always_present(self):
        em = Dampr.memory([1]).map(lambda x: x).run()
        p = em.stats()["plan"]
        for key in ("enabled", "adaptive", "cost", "lowering", "pipeline",
                    "analysis", "stage_shapes"):
            assert key in p, key
        assert p["enabled"] is True
        em.delete()

        runner = dampr_tpu_torch.runner.MTRunner(
            "plan-never", Dampr.memory([1]).map(lambda x: x).pmer.graph)

        def refuse(*_a, **_k):
            raise RuntimeError("planning refused")

        old = plan.prepare
        plan.prepare = refuse
        try:
            with pytest.raises(RuntimeError):
                runner.run([runner.graph.stages[-1].output])
        finally:
            plan.prepare = old
        p = runner.run_summary["plan"]
        assert p["enabled"] is False
        assert set(p) >= {"adaptive", "cost", "lowering", "pipeline",
                          "analysis", "stage_shapes"}


def test_explain_renders_analysis_section():
    acc = []
    pipe = (Dampr.memory(list(range(30)))
            .map(lambda x: (acc.append(x), x)[1]))
    text = pipe.explain()
    assert "analysis:" in text
    assert "DTA201" in text and "'acc'" in text
    settings.analyze = False
    assert "analysis: off" in pipe.explain()
    assert not acc  # explain ran nothing


# -- against the JAX package on one corpus -----------------------------------

def _fold(pkg):
    return (pkg.Dampr.memory(list(range(3000)), partitions=4)
            .map(lambda x: (x % 7, x))
            .fold_by(lambda kv: kv[0], operator.add, lambda kv: kv[1]))


def _fat(pkg):
    # 300-byte values: history asks for a smaller batch_size
    return (pkg.Dampr.memory(list(range(2000)), partitions=4)
            .map(lambda x: "v" * 300 + str(x))
            .group_by(lambda s: len(s))
            .reduce(lambda k, vs: sum(1 for _ in vs)))


def _sort(pkg):
    return pkg.Dampr.memory(list(range(1500))).sort_by(lambda x: -x)


def _count(pkg):
    return pkg.Dampr.memory(list(range(4000))).count(lambda x: x % 11)


def _chain(pkg):
    return (pkg.Dampr.memory(list(range(800)), partitions=3)
            .map(lambda x: x * 2).checkpoint()
            .filter(lambda x: x % 3 != 0))


PIPES = {"fold": _fold, "fat": _fat, "sort": _sort, "count": _count,
         "chain": _chain}


def _stub(name, graph):
    return types.SimpleNamespace(
        name=name, graph=graph, n_partitions=64,
        _explicit_partitions=False, resume=False, store=None,
        plan_report=None, _handoff_sids=set(), _shuffle_targets={},
        _pipeline_edges={})


def _plans(build, name):
    """(port runner, port report, JAX runner, JAX report) of planning
    ``build``'s pipeline under ``name`` in each package."""
    pp, rp = build(dampr_tpu_torch), build(dampr_tpu)
    port = _stub(name, pp.pmer.graph)
    port.graph, port_rep = plan.prepare(pp.pmer.graph, [pp.source],
                                        runner=port)
    ref = _stub(name, rp.pmer.graph)
    ref_rep = ref_plan.apply_to_runner(ref, [rp.source])
    return port, port_rep, ref, ref_rep


def _comparable(section, rep):
    """A report section; a pipeline edge's ``output`` is its Source's
    process-wide serial number, which differs between any two handles."""
    sec = rep[section]
    if section == "pipeline":
        sec = dict(sec, edges=[{k: v for k, v in e.items() if k != "output"}
                               for e in sec["edges"]])
    return sec


def _stage_options(graph):
    return [{k: v for k, v in s.options.items()
             if k in ("batch_size", "n_reducers")} for s in graph.stages]


@pytest.mark.parametrize("runs", [0, 1, 2, 4])
@pytest.mark.parametrize("pipe", sorted(PIPES))
def test_report_sections_equal_on_one_corpus(pipe, runs):
    name = "sections-" + pipe
    for _ in range(runs):
        em = PIPES[pipe](dampr_tpu_torch).run(name=name)
        em.delete()
    assert len(history.load(name)) == runs
    port, port_rep, ref, ref_rep = _plans(PIPES[pipe], name)
    for section in ("adaptive", "cost", "pipeline", "stage_shapes"):
        assert _comparable(section, port_rep) == \
            _comparable(section, ref_rep), section
    assert port_rep["rules"].get("adaptive") == \
        ref_rep["rules"].get("adaptive")
    assert port.n_partitions == ref.n_partitions
    assert _stage_options(port.graph) == _stage_options(ref.graph)
    assert port._pipeline_edges == ref._pipeline_edges
    if runs >= 1 and pipe in ("fold", "count"):
        assert port_rep["adaptive"]["applied"] is True


@pytest.mark.parametrize("knob, value", [("cost_model", "off"),
                                         ("plan_adapt", False),
                                         ("pipeline", "off")])
def test_switches_equal_on_one_corpus(knob, value):
    name = "switch-" + knob
    for _ in range(4):
        PIPES["fold"](dampr_tpu_torch).run(name=name).delete()
    setattr(settings, knob, value)
    setattr(ref_settings, knob, value)
    port, port_rep, ref, ref_rep = _plans(PIPES["fold"], name)
    assert port_rep["adaptive"] == ref_rep["adaptive"]
    assert _comparable("pipeline", port_rep) == \
        _comparable("pipeline", ref_rep)
    assert port.n_partitions == ref.n_partitions
    assert port._pipeline_edges == ref._pipeline_edges
    if knob == "cost_model":
        # the reason names each package's own switch
        assert port_rep["cost"]["reason"].startswith("disabled")
        assert ref_rep["cost"]["reason"].startswith("disabled")
        port_rep["cost"].pop("reason")
        ref_rep["cost"].pop("reason")
    assert port_rep["cost"] == ref_rep["cost"]


def _sections(text):
    """``explain()`` text less the sections the port renders for its own
    reasons (the shuffle route of one card, the reuse line)."""
    out, skip = [], False
    for line in text.splitlines():
        if line.startswith(("shuffle:", "reuse:")):
            skip = True
            continue
        if skip and line.startswith("  "):
            continue
        skip = False
        out.append(line)
    return out


def _reason_free(line):
    """A device target or resident handoff line without its reason."""
    head = line.split("  (", 1)[0]
    if head.endswith(("-> device", ": device")):
        return head
    return line


@pytest.mark.parametrize("lowering", ["off", "on"])
@pytest.mark.parametrize("runs", [0, 3])
@pytest.mark.parametrize("pipe", sorted(PIPES) + ["docfreq"])
def test_explain_equal_line_for_line(tmp_path, pipe, runs, lowering):
    corpus = tmp_path / "c.txt"
    corpus.write_text("a b c\nb c d\nc d e\n" * 200)

    def build(pkg):
        if pipe != "docfreq":
            return PIPES[pipe](pkg)
        text = port_text if pkg is dampr_tpu_torch else ref_text
        return (pkg.Dampr.text(str(corpus), 2000)
                .custom_mapper(text.DocFreq(pair_values=False))
                .fold_values(operator.add))

    name = "explain-{}-{}".format(pipe, lowering)
    for _ in range(runs):
        build(dampr_tpu_torch).run(name=name).delete()
    settings.lower = ref_settings.lower = lowering
    got = build(dampr_tpu_torch).explain(name=name)
    want = build(dampr_tpu).explain(name=name)
    g, w = _sections(got), _sections(want)
    assert len(g) == len(w), (got, want)
    for a, b in zip(g, w):
        assert a == b or _reason_free(a) == _reason_free(b), (a, b)
    assert "reuse: off" in got
    for line in got.splitlines():
        if "shuffle -> " in line:
            assert ("-> host  (single visible device" in line
                    or "-> device  (device-lowered fold" in line), line


# -- handoff_analyze's priced branch -----------------------------------------

def _docfreq(pkg, path):
    text = port_text if pkg is dampr_tpu_torch else ref_text
    return (pkg.Dampr.text(path, 2000)
            .custom_mapper(text.DocFreq(pair_values=False))
            .fold_values(operator.add))


def _priced_corpus(name, shapes, spill_faster, n_each=2):
    """A hand-written corpus of lowered runs: ``n_each`` with the edge
    resident and ``n_each`` spilled, the spilled ones faster or slower
    per input MB."""
    import json
    import os

    path = history.corpus_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fp = history.plan_fingerprint(shapes)
    with open(path, "w") as f:
        for i in range(2 * n_each):
            resident = i % 2 == 0
            wall = 4.0 + 0.1 * i
            if resident == spill_faster:
                wall += 3.0
            f.write(json.dumps({
                "schema": history.SCHEMA, "run": name, "ts": float(i),
                "wall_seconds": wall, "stage_shapes": shapes,
                "fingerprint": fp, "device_fraction": 0.25,
                "handoff": {"edges": 1 if resident else 0, "degrades": 0},
                "stages": [{"stage": s["sid"], "kind": s["shape"].split(
                    ":")[0], "bytes_in": 128_000_000, "records_out": 10 ** 6,
                    "seconds": 1.0} for s in shapes]}) + "\n")


@pytest.mark.parametrize("spill_faster", [True, False, None])
def test_priced_handoff_equal_on_one_corpus(tmp_path, spill_faster):
    corpus = tmp_path / "c.txt"
    corpus.write_text("x y z\ny z w\n" * 500)
    pp, rp = _docfreq(dampr_tpu_torch, str(corpus)), _docfreq(
        dampr_tpu, str(corpus))
    pg, _ = passes.optimize(pp.pmer.graph, [pp.source])
    rg, _ = ref_passes.optimize(rp.pmer.graph, [rp.source])
    name = "priced-{}".format(spill_faster)
    if spill_faster is not None:
        _priced_corpus(name, plan.ir.stage_shapes(pg), spill_faster)
    settings.lower, ref_settings.lower = "on", "1"
    settings.handoff = ref_settings.handoff = "auto"
    got = lower.handoff_analyze(pg, lower.analyze(pg, [pp.source]),
                                run_name=name)
    want = ref_lower.handoff_analyze(rg, ref_lower.analyze(
        rg, None, [rp.source]), run_name=name)
    assert [(e["src"], e["dst"], e["handoff"], e["kind"]) for e in got] \
        == [(e["src"], e["dst"], e["handoff"], e["kind"]) for e in want]
    edge, ref_edge = got[0], want[0]
    if spill_faster:
        assert (edge["handoff"], edge["kind"]) == ("spill", "priced")
        assert edge["reason"] == ref_edge["reason"]
        assert "spill path faster" in edge["reason"]
    else:
        assert edge["handoff"] == "device"
        # the corpus's verdict rides the resident edge's reason
        assert edge["reason"].split("skipped on this edge")[1] == \
            ref_edge["reason"].split("skipped on this edge")[1]
    # a forced handoff is never priced; an unnamed run has no corpus
    settings.handoff = "on"
    forced = lower.handoff_analyze(pg, lower.analyze(pg, [pp.source]),
                                   run_name=name)
    assert forced[0]["handoff"] == "device"
    settings.handoff = "auto"
    unnamed = lower.handoff_analyze(pg, lower.analyze(pg, [pp.source]))
    assert unnamed[0]["kind"] == "resident"


def test_priced_spill_runs_the_spill_path_exactly(tmp_path):
    corpus = tmp_path / "c.txt"
    corpus.write_text("".join("w{} w{} w{}\n".format(i % 13, i % 7, i % 5)
                              for i in range(3000)))
    want = sorted(_docfreq(dampr_tpu, str(corpus)).read())
    pp = _docfreq(dampr_tpu_torch, str(corpus))
    pg, _ = passes.optimize(pp.pmer.graph, [pp.source])
    name = "priced-run"
    _priced_corpus(name, plan.ir.stage_shapes(pg), spill_faster=True)
    settings.lower = "on"
    em = pp.run(name=name)
    assert sorted(em.read()) == want
    stats = em.stats()
    edges = stats["plan"]["lowering"]["handoff"]
    assert [(e["handoff"], e["kind"]) for e in edges] == [("spill",
                                                           "priced")]
    assert stats["device"]["handoff_edges"] == 0
    assert stats["device"]["handoff_bytes"] == 0
    em.delete()
    # the run's own record joined the corpus, on the spilled side
    rec = history.load(name)[-1]
    assert rec["handoff"]["edges"] == 0


def test_history_placement_floor_equal(tmp_path):
    """A stage whose history shows fewer than ``LOWER_MIN_RECORDS``
    records goes back to the host, for the JAX package's reason."""
    corpus = tmp_path / "c.txt"
    corpus.write_text("q r\n" * 50)
    pp, rp = _docfreq(dampr_tpu_torch, str(corpus)), _docfreq(
        dampr_tpu, str(corpus))
    pg, _ = passes.optimize(pp.pmer.graph, [pp.source])
    rg, _ = ref_passes.optimize(rp.pmer.graph, [rp.source])
    hist = {"stages": [{"stage": s["sid"], "records_out": 2}
                       for s in plan.ir.stage_shapes(pg)]}
    got = lower.analyze(pg, [pp.source], hist)
    want = ref_lower.analyze(rg, hist, [rp.source])
    assert [(d["sid"], d["target"]) for d in got] == \
        [(d["sid"], d["target"]) for d in want]
    assert all(d["target"] == "host" and "lower_min_records" in d["reason"]
               for d in got)
    assert [d["reason"] for d in got] == [d["reason"] for d in want]


# -- records do not depend on how history cuts the blocks --------------------

def _chain_fold(pkg):
    # a certified numeric chain: with lowering on it runs as the lane
    # program, batch by batch
    return (pkg.Dampr.memory(list(range(-3000, 9000)), partitions=3)
            .map(lambda x: x * 3 + 1).filter(lambda x: x % 2 == 0)
            .fold_by(lambda x: x % 97, operator.add))


def _words(pkg):
    return (pkg.Dampr.memory(["w{} v{} u{}".format(i % 31, i % 7, i % 3)
                              for i in range(5000)], partitions=4)
            .flat_map(lambda s: s.split())
            .fold_by(lambda w: w, operator.add, lambda w: 1))


def _sized_corpus(name, graph, record_bytes):
    """One hand-written record whose map stages emitted
    ``record_bytes``-byte records, so the next run under ``name`` cuts
    its map blocks to ``plan_block_bytes / record_bytes`` records."""
    import json
    import os

    shapes = plan.ir.stage_shapes(graph)
    path = history.corpus_path(name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(json.dumps({
            "schema": history.SCHEMA, "run": name, "wall_seconds": 1.0,
            "stage_shapes": shapes,
            "fingerprint": history.plan_fingerprint(shapes),
            "stages": [{"stage": s["sid"], "kind": s["shape"].split(":")[0],
                        "records_out": 1000,
                        "bytes_out": 1000 * record_bytes,
                        "bytes_in": 1000 * record_bytes, "seconds": 0.1}
                       for s in shapes]}) + "\n")


@pytest.mark.parametrize("record_bytes", [1 << 19, 1 << 15, 1 << 10])
@pytest.mark.parametrize("lowering", ["off", "on"])
@pytest.mark.parametrize("pipe", ["chain_fold", "words", "fat"])
def test_adapted_batch_size_keeps_records(pipe, lowering, record_bytes):
    build = {"chain_fold": _chain_fold, "words": _words, "fat": _fat}[pipe]
    settings.lower = ref_settings.lower = lowering
    want = build(dampr_tpu).read()
    pp = build(dampr_tpu_torch)
    pg, _ = passes.optimize(pp.pmer.graph, [pp.source])
    name = "batch-{}-{}-{}".format(pipe, lowering, record_bytes)
    _sized_corpus(name, pg, record_bytes)
    em = pp.run(name=name)
    got = em.read()
    changes = em.stats()["plan"]["adaptive"]["changes"]
    em.delete()
    assert got == want
    sizes = {c["to"] for c in changes if c["what"] == "batch_size"}
    assert sizes == {max(16, settings.plan_block_bytes // record_bytes)}
