import hashlib
import json
import os
import re

import pytest

from portbench import corpus, registry
from portbench.tests.conftest import PKG, TINY_BASE, tiny_traffic

base_text = registry.load_module("makers", "shakespeare").base_text

RX = re.compile(r"[^\w]+")


def _words(text):
    out = set()
    for line in text.split("\n"):
        out.update(t for t in RX.split(line.lower()) if t)
    return out


def test_tiny_base_is_deterministic_and_of_its_size():
    base = tiny_traffic()["base"]
    a = base_text(base, 2 ** 31 + 77)
    b = base_text(base, 2 ** 31 + 77)
    c = base_text(base, 3)
    assert a == b
    assert a != c
    assert len(a) == len(c) == TINY_BASE["bytes"]
    assert len(_words(a)) == len(_words(c)) == sum(
        TINY_BASE["word_lengths"].values())


def test_seeds_share_every_count():
    """Two seeds give the same tokens per length and the same lines."""
    base = tiny_traffic()["base"]
    texts = [base_text(base, s) for s in (1, 2 ** 40 + 5, -9)]

    def shape(text):
        toks = [t for t in RX.split(text.lower()) if t]
        lens = sorted(len(t) for t in toks)
        return (lens, text.count("\n"), text.count(","),
                sum(1 for line in text.split("\n") if line == ""))
    assert shape(texts[0]) == shape(texts[1]) == shape(texts[2])


@pytest.mark.parametrize("name", ["shakespeare-1x", "shakespeare-20x"])
def test_upstream_base_shape(name):
    """The 5.3 MB base has upstream's 23,903 distinct lower-cased words,
    words of 1 to 27 bytes, and its stated size."""
    with open(os.path.join(PKG, "traffic", name + ".json")) as f:
        traffic = json.load(f)
    text = base_text(traffic["base"], 123456789012)
    assert len(text) == traffic["base"]["bytes"] == 5300000
    words = _words(text)
    assert len(words) == 23903
    assert min(map(len, words)) == 1 and max(map(len, words)) == 27
    assert any(c.isupper() for c in text[:2000])
    assert text.endswith("\n")


def test_write_corpus_copies(tmp_path):
    path = str(tmp_path / "c.txt")
    assert corpus.write_copies(path, b"ab\ncd\n", 3) == {
        "stored_bytes": 18}
    assert open(path).read() == "ab\ncd\n" * 3
    assert corpus.read_once(path) == (
        18, hashlib.sha256(b"ab\ncd\n" * 3).hexdigest())
    assert corpus.chunk_size(18, 8) == 3
    assert corpus.chunk_size(16, 8) == 2
