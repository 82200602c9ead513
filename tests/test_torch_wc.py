"""``examples/wc.py`` and ``examples/word_stats.py`` through both packages.

The two examples' pipelines, built against ``dampr_tpu`` and
``dampr_tpu_torch`` (device="cpu"), on the small corpora of
``test_torch_pipeline.py`` and on a corpus from ``bench_tfidf``'s
generator, must read back equal records, ``top_words``' records that tie
on their count in the JAX package's order (both packages fold the small
``count()`` in one pass, the tiny fold, which leaves it in hash order
within a partition, and ``sort_by`` keeps that order).  Tolerance: exact; the
average word length is one division of equal integers on both sides.

On the CPU device a combine batch of at least the CPU floor of
``settings.use_device_for`` (4,096) takes the device branch: the key
lanes come from K1's plain version, which these tests count.  The string
key encoding that feeds it must equal the JAX package's.
"""

import collections

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import bench_tfidf
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import hashing as ref_hashing
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import hashing as port_hashing

from test_torch_pipeline import CORPORA


@pytest.fixture(autouse=True)
def knobs():
    old = (ref_settings.partitions, port_settings.partitions,
           port_settings.device)
    ref_settings.partitions = port_settings.partitions = 8
    port_settings.device = "cpu"
    yield
    (ref_settings.partitions, port_settings.partitions,
     port_settings.device) = old


def wc(pkg, path, chunk_size):
    """``examples/wc.py``'s ``build()``, but for the chunk size."""
    return (pkg.Dampr.text(path, chunk_size=chunk_size)
            .flat_map(lambda line: line.split())
            .fold_by(lambda w: w, binop=lambda x, y: x + y,
                     value=lambda w: 1))


def word_stats(pkg, fname, chunk_size):
    """``examples/word_stats.py``'s ``build()``, but for the chunk size."""
    words = pkg.Dampr.text(fname, chunk_size).flat_map(
        lambda line: line.split())
    top_words = (words.count(lambda x: x)
                 .sort_by(lambda word_count: -word_count[1]))
    total_count = top_words.fold_by(
        key=lambda word: 1, value=lambda x: x[1], binop=lambda x, y: x + y)
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


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _split_counts(path):
    with open(path, encoding="utf-8", errors="replace") as f:
        return collections.Counter(w for line in f for w in line.split())


def _bench_corpus(tmp_path):
    """A small corpus from the TF-IDF benchmark's own generator."""
    path = str(tmp_path / "bench.txt")
    bench_tfidf.make_corpus(path, 1)
    with open(path, "rb") as f:
        head = f.read(600 * 1024)
    return _write(tmp_path, "bench_head.txt", head[:head.rfind(b"\n") + 1])


def _corpus(tmp_path, name):
    if name == "bench":
        return _bench_corpus(tmp_path)
    return _write(tmp_path, name + ".txt", CORPORA[name]())


NAMES = sorted(CORPORA) + ["bench"]
UTF8 = [n for n in NAMES if n != "invalid_utf8"]


@pytest.mark.parametrize("name", UTF8)
def test_wc_reads_back_what_the_jax_package_does(tmp_path, name):
    path = _corpus(tmp_path, name)
    chunk = 4096 if name != "bench" else 150 * 1024
    want = wc(dampr_tpu, path, chunk).read()
    em = wc(dampr_tpu_torch, path, chunk).run()
    got = em.read()
    assert got == want
    assert got == sorted(_split_counts(path).items())
    plan = em.stats()["plan"]
    assert (plan["stages_before"], plan["stages_after"]) == (4, 2)


def test_wc_on_invalid_utf8_fails_as_the_jax_package_does(tmp_path):
    path = _corpus(tmp_path, "invalid_utf8")
    errors = []
    for pkg in (dampr_tpu, dampr_tpu_torch):
        with pytest.raises(UnicodeDecodeError) as e:
            wc(pkg, path, 4096).read()
        errors.append(e.value.reason)
    assert errors[0] == errors[1]


@pytest.mark.parametrize("name", UTF8)
def test_word_stats_reads_back_what_the_jax_package_does(tmp_path, name):
    path = _corpus(tmp_path, name)
    chunk = 4096 if name != "bench" else 150 * 1024
    ref = [em.read() for em in
           dampr_tpu.Dampr.run(*word_stats(dampr_tpu, path, chunk))]
    got = [em.read() for em in
           dampr_tpu_torch.Dampr.run(*word_stats(dampr_tpu_torch, path,
                                                 chunk))]
    tc, tw, wl, awl = got
    assert tc == ref[0]
    # ties in the JAX package's order: both sides fold ``count()`` with
    # the tiny associative fold (hash order within a partition), then
    # sort stably
    assert tw == ref[1]
    assert wl == ref[2]
    assert awl == ref[3]
    counts = _split_counts(path)
    if counts:
        assert tc == [(1, sum(counts.values()))]


def test_wc_combine_takes_the_device_branch_on_the_cpu(tmp_path):
    """Blocks of >= 4,096 words hash through K1's entry (its plain version
    on the CPU) and sort and fold through the device helpers."""
    path = _bench_corpus(tmp_path)
    assert port_settings.use_device_for(4096)
    em = wc(dampr_tpu_torch, path, 300 * 1024).run()
    assert em.read() == sorted(_split_counts(path).items())
    dev = em.stats()["device"]
    assert dev["keyed"]["fnv_lanes"]["calls"] > 0
    assert dev["keyed"]["hash_sort"]["calls"] > 0
    # no stage is lowered: every byte copied is a keyed op's
    assert dev["device_stages"] == 0
    assert dev["h2d_bytes"] > 0 and dev["d2h_bytes"] > 0


def test_count_folds_on_the_device_branch(tmp_path):
    path = _bench_corpus(tmp_path)
    em = (dampr_tpu_torch.Dampr.text(path, 300 * 1024)
          .flat_map(lambda line: line.split()).count()).run()
    assert em.read() == sorted(_split_counts(path).items())
    assert em.stats()["device"]["keyed"]["segment_fold"]["calls"] > 0


def test_string_key_encoding_matches_the_jax_package():
    rng = np.random.RandomState(5)
    keys = (["", "a", "naïve", "日本語", "x" * 3000, "y" * 1024, "z" * 1025]
            + ["w%d" % i for i in rng.randint(0, 10 ** 6, 500)]
            + [b"\x00\xff", b""])
    for batch in (keys, keys[:1], ["", ""], [b"ab"]):
        got = port_hashing.encode_str_keys(batch)
        want = ref_hashing.encode_str_keys(batch)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    empty = port_hashing.encode_str_keys([])
    assert empty[0].shape == (0, 8) and empty[1].shape == (0,)
