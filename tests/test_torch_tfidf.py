"""The TF-IDF benchmark's pipeline through both packages.

``docs.custom_mapper(DocFreq).fold_values(add).cross_right(docs.len(),
idf, memory=True).sink_tsv(out)`` (``dampr_tpu/bench_tfidf.py:135-147``)
runs through dampr_tpu with lowering forced on (its CPU jit leg) and off,
and through dampr_tpu_torch (device="cpu": the kernels' plain versions)
with lowering forced on and off.  The records read back and the sorted
sink lines must be equal across all four legs; the port's lowered leg
must run the DocFreq stage on the device although its tap is shared with
the ``len()`` scan.  Tolerance: exact (both sides compute the idf float
in Python from the same integers).
"""

import math
import operator
import os

import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import bench_tfidf
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import text as port_text
from dampr_tpu_torch.plan import lower as port_plan_lower

from test_torch_pipeline import CORPORA, _write


@pytest.fixture(autouse=True)
def knobs():
    old = (ref_settings.lower, port_settings.device, port_settings.lower,
           port_settings.handoff)
    port_settings.device = "cpu"
    # the classic lowered program; the TF-IDF pipeline with the handoff on
    # is tests/test_torch_handoff.py's
    port_settings.handoff = "off"
    yield
    (ref_settings.lower, port_settings.device, port_settings.lower,
     port_settings.handoff) = old


def _idf(df, total):
    return df[0], df[1], math.log(1 + float(total) / df[1])


def _pipeline(pkg, text, path, chunks):
    docs = pkg.Dampr.text(path, max(1, os.path.getsize(path) // chunks + 1))
    doc_freq = (docs.custom_mapper(text.DocFreq(mode="word", lower=True,
                                                pair_values=False))
                .fold_values(operator.add))
    return docs, doc_freq.cross_right(docs.len(), _idf, memory=True)


def _run(pkg, text, path, sink_dir, chunks=3):
    """(records, sorted sink lines, the sink run's stats summary)."""
    _docs, idf = _pipeline(pkg, text, path, chunks)
    em = idf.run(name="tfidf-parity")
    records = em.read()
    em.delete()
    em = idf.sink_tsv(sink_dir).run(name="tfidf-parity-sink")
    lines = []
    for part in sorted(os.listdir(sink_dir)):
        with open(os.path.join(sink_dir, part), "rb") as f:
            lines.extend(f.read().splitlines())
    return records, sorted(lines), em.stats()


def _bench_corpus(tmp_path):
    path = str(tmp_path / "bench_corpus.txt")
    bench_tfidf.make_corpus(path, 0.25)  # the benchmark's generator
    return path


def _corpus_path(tmp_path, corpus):
    if corpus == "bench":
        return _bench_corpus(tmp_path)
    return _write(tmp_path, "c.txt", CORPORA[corpus]())


@pytest.mark.parametrize("corpus", sorted(CORPORA) + ["bench"])
def test_tfidf_four_legs_agree(tmp_path, corpus):
    path = _corpus_path(tmp_path, corpus)
    legs = {}
    for name, pkg, text, settings in (
            ("ref", dampr_tpu, ref_text, ref_settings),
            ("port", dampr_tpu_torch, port_text, port_settings)):
        for lower in ("1", "0"):
            settings.lower = lower
            legs[name, lower] = _run(pkg, text, path,
                                     str(tmp_path / (name + lower)))
    records, lines, _ = legs["ref", "1"]
    assert records and lines
    for key, (r, l, _stats) in legs.items():
        assert r == records, key
        assert l == lines, key
    on = legs["port", "1"][2]["device"]
    assert on["device_stages"] >= 1
    assert on["batches"] >= 1
    assert legs["port", "0"][2]["device"]["device_stages"] == 0


@pytest.mark.parametrize("corpus", ["no_trailing_newline", "blank_windows",
                                    "text", "bench"])
@pytest.mark.parametrize("chunks", [1, 7])
def test_len_counts_lines(tmp_path, corpus, chunks):
    path = _corpus_path(tmp_path, corpus)
    with open(path, "rb") as f:
        data = f.read()
    want = data.count(b"\n") + (1 if data and not data.endswith(b"\n")
                                else 0)
    got = {}
    for pkg in (dampr_tpu, dampr_tpu_torch):
        docs = pkg.Dampr.text(path, max(1, len(data) // chunks + 1))
        got[pkg.__name__] = docs.len().read()
    assert got == {"dampr_tpu": [want], "dampr_tpu_torch": [want]}


def test_len_of_an_empty_file(tmp_path):
    path = _write(tmp_path, "empty.txt", b"")
    assert dampr_tpu_torch.Dampr.text(path).len().read() == [0]
    assert dampr_tpu.Dampr.text(path).len().read() == [0]


def test_docfreq_lowers_beside_the_len_branch(tmp_path):
    """Lowering reads the consumers of DocFreq's output only: the tap's
    other reader (the len() scan) leaves it on the device, and the
    two-input cross stays on the host."""
    from dampr_tpu_torch import plan

    path = _write(tmp_path, "c.txt", b"a b\n")
    _docs, idf = _pipeline(dampr_tpu_torch, port_text, path, 1)
    graph, _report = plan.prepare(idf.pmer.graph, [idf.source])
    decisions = port_plan_lower.analyze(graph, outputs=[idf.source])
    by_op = {}
    for d in decisions:
        stage = graph.stages[d["sid"]]
        op = getattr(stage, "mapper", None) or stage.reducer
        by_op[type(op).__name__] = (d["target"], d["reason"])
    assert by_op["DocFreq"][0] == "device"
    assert by_op["CountRecords"][0] == "host"
    assert by_op["MapCrossJoin"] == ("host", "multi-input map (join "
                                             "shapes stay host)")
