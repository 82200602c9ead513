"""Scan sharing in dampr_tpu_torch: map stages that read the same tap run
over one pass of its chunks, against the JAX package.

The TF-IDF benchmark's pipeline (``bench_tfidf.py:135-147``: DocFreq ->
``fold_values`` -> ``cross_right(docs.len(), idf, memory=True)`` ->
``sink_tsv``) over a plain and a BGZF corpus made from a seed with numpy:
DocFreq and ``len()`` fuse into one group, the tap is read once per chunk
(in one window pass for plain text, one shared read of the inflated
chunk for BGZF), and the sink's part files hold the JAX package's bytes
with its scan sharing on and off, lowering on and off on the port.
Tolerance: exact.
"""

import collections
import math
import operator
import os

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops.text import DocFreq as RefDocFreq
from dampr_tpu_torch import dataset as port_dataset
from dampr_tpu_torch import inputs as port_inputs
from dampr_tpu_torch import settings
from dampr_tpu_torch.ops.text import DocFreq

from test_ingest import write_bgzf

_NAMES = ("partitions", "lower")


@pytest.fixture(autouse=True)
def knobs():
    old = {n: getattr(settings, n) for n in _NAMES + ("device", "handoff")}
    old_ref = (ref_settings.partitions, ref_settings.scan_sharing)
    settings.partitions = ref_settings.partitions = 8
    settings.device = "cpu"
    # the classic lowered program (its batches are counted below)
    settings.handoff = "off"
    yield
    for n, v in old.items():
        setattr(settings, n, v)
    ref_settings.partitions, ref_settings.scan_sharing = old_ref


def _corpus_text(seed=51, lines=3000):
    rng = np.random.RandomState(seed)
    vocab = ["w%d" % i for i in range(300)] + ["Naïve", "THE", "a-b"]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    out = []
    for _ in range(lines):
        out.append(" ".join(vocab[j] for j in rng.choice(
            len(vocab), rng.randint(1, 12), p=p)))
    return "\n".join(out) + "\n"


@pytest.fixture(params=["text", "bgzf"])
def corpus(request, tmp_path):
    text = _corpus_text()
    if request.param == "text":
        path = str(tmp_path / "corpus.txt")
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
    else:
        path = str(tmp_path / "corpus.gz")
        write_bgzf(path, text, block_lines=97)
    return request.param, path, text


def tfidf(pkg, DF, path, chunk, out_dir):
    docs = pkg.Dampr.text(path, chunk)
    doc_freq = (docs.custom_mapper(
        DF(mode="word", lower=True, pair_values=False))
        .fold_values(operator.add))
    idf = doc_freq.cross_right(
        docs.len(),
        lambda df, total: (df[0], df[1],
                           math.log(1 + (float(total) / df[1]))),
        memory=True)
    return idf.sink_tsv(out_dir)


def _parts(d):
    out = []
    for p in sorted(os.listdir(d)):
        with open(os.path.join(d, p), "rb") as f:
            out.append(f.read())
    return out


def _count_reads(monkeypatch):
    """Count each chunk's byte reads (``read_bytes`` and
    ``iter_byte_blocks`` calls) on the port's taps, by chunk start."""
    reads = collections.Counter()
    for cls in (port_dataset.TextLineDataset, port_inputs.BgzfChunkDataset):
        for name in ("read_bytes", "iter_byte_blocks"):
            real = getattr(cls, name, None)
            if real is None:
                continue

            def counted(self, *a, _real=real, **k):
                reads[self.start] += 1
                return _real(self, *a, **k)

            monkeypatch.setattr(cls, name, counted)
    return reads


@pytest.mark.parametrize("lower", ["0", "1"])
def test_one_pass_feeds_doc_freq_and_len(corpus, tmp_path, monkeypatch,
                                         lower):
    kind, path, _text = corpus
    chunk = 6000
    want = {}
    for sharing in (True, False):
        ref_settings.scan_sharing = sharing
        out = str(tmp_path / "ref-{}".format(sharing))
        tfidf(dampr_tpu, RefDocFreq, path, chunk, out).run()
        want[sharing] = _parts(out)
    assert want[True] == want[False]
    assert b"".join(want[True]).count(b"\n") > 0

    settings.lower = lower
    n_chunks = len(port_inputs.plan_chunks(path, chunk))
    assert n_chunks > 3
    reads = _count_reads(monkeypatch)
    out = str(tmp_path / "port")
    em = tfidf(dampr_tpu_torch, DocFreq, path, chunk, out).run()
    monkeypatch.undo()
    assert _parts(out) == want[True], kind
    stats = em.stats()
    assert sorted(reads.values()) == [1] * n_chunks
    groups = stats["scan_sharing"]["groups"]
    assert len(groups) == 1
    assert len(groups[0]["stages"]) == 2
    assert groups[0]["chunks"] == n_chunks
    # a BGZF chunk streams no bytes: its members share one read instead
    assert groups[0]["windowed"] == (n_chunks if kind == "text" else 0)
    assert (stats["device"]["batches"] > 0) == (lower == "1")


def test_per_record_members_read_on_their_own(tmp_path):
    """Members without a window sink (record maps) still fuse into the
    group and read their chunk themselves; results equal the JAX
    package's."""
    path = str(tmp_path / "c.txt")
    with open(path, "w", encoding="utf-8") as f:
        f.write(_corpus_text(seed=52, lines=400))

    def pipes(pkg):
        docs = pkg.Dampr.text(path, 3000)
        return (docs.map(lambda line: len(line)).fold_by(
                    lambda n: n % 7, operator.add),
                docs.len(),
                docs.flat_map(str.split).count())

    want = [em.read() for em in dampr_tpu.Dampr.run(*pipes(dampr_tpu))]
    ems = dampr_tpu_torch.Dampr.run(*pipes(dampr_tpu_torch))
    assert [em.read() for em in ems] == want
    groups = ems[0].stats()["scan_sharing"]["groups"]
    assert len(groups) == 1 and len(groups[0]["stages"]) == 3
