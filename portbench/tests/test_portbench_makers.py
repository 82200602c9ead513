"""The makers: the Shakespeare maker gives the plain corpus the harness
made before makers existed, byte for byte, and its BGZF file is what
``bgzip`` writes by default, read back with the standard library alone."""

import ast
import gzip
import hashlib
import json
import os
import struct
import zlib

import pytest

from portbench import corpus, registry
from portbench.tests.conftest import PKG

#: SHA-256 of the corpus the harness wrote before makers existed (its
#: ``base_text`` and ``write_corpus``), for these traffic files and seeds.
PINNED = {("shakespeare-1x", 2 ** 31 + 17):
          "c2466611407788ab619319ad9e00977c9fdbf9b283c76e9b97cf5f41fdfe540e",
          ("shakespeare-20x", 5):
          "b01ea3909fcdce60ed64bf1ab65a55d26e5afe875e7d3860e12b86e22ebf875b"}

#: The 28-byte empty member that ends a BGZF file (SAM/BAM specification,
#: section 4.1.2).
EOF_MEMBER = bytes([31, 139, 8, 4, 0, 0, 0, 0, 0, 255, 6, 0, 66, 67, 2, 0,
                    27, 0, 3, 0, 0, 0, 0, 0, 0, 0, 0, 0])


def _make(name, seed, work_dir):
    bench = registry.Bench()
    traffic = bench.traffic(name)
    return bench.maker(traffic).make(traffic, seed, str(work_dir), bench)


def _sha_of_copies(text, factor):
    digest = hashlib.sha256()
    data = text.encode("ascii")
    for _ in range(factor):
        digest.update(data)
    return digest.hexdigest()


@pytest.mark.parametrize("name", ["shakespeare-1x", "shakespeare-20x"])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 17])
def test_shakespeare_maker_writes_the_plain_copies(tmp_path, name, seed):
    made = _make(name, seed, tmp_path)
    text, factor = made["truth"]
    with open(os.path.join(PKG, "traffic", name + ".json")) as f:
        traffic = json.load(f)
    assert traffic["maker"] == "shakespeare"
    assert factor == traffic["factor"]
    assert text == registry.load_module("makers", "shakespeare").base_text(
        traffic["base"], seed)
    n, sha = corpus.read_once(made["input"])
    assert sha == _sha_of_copies(text, factor)
    if (name, seed) in PINNED:
        assert sha == PINNED[(name, seed)]
    assert n == made["bytes"] == made["stored_bytes"] == len(text) * factor
    assert made["input"].endswith("corpus.txt")


def _members(data):
    """Each member's header fields, deflated body and trailer."""
    out, off = [], 0
    while off < len(data):
        (id1, id2, cm, flg, _mtime, _xfl, _os, xlen, si1, si2, slen,
         bsize) = struct.unpack_from("<BBBBIBBHBBHH", data, off)
        assert (id1, id2, cm, flg) == (31, 139, 8, 4)
        assert (xlen, si1, si2, slen) == (6, 66, 67, 2)  # the BC subfield
        size = bsize + 1
        crc, isize = struct.unpack_from("<II", data, off + size - 8)
        out.append((data[off + 18:off + size - 8], crc, isize))
        off += size
    assert off == len(data)
    return out


def test_bgzf_file_is_bgzips_default(tmp_path):
    """The 20-copy BGZF corpus inflates, with ``gzip`` alone, to exactly
    ``shakespeare-20x``'s plain corpus of the seed; every member carries
    ``BC``, holds at most 65,280 bytes of input and is deflated as zlib's
    level 6 does; the file ends with the empty member and has no index."""
    seed = 2 ** 31 + 17
    made = _make("shakespeare-20x-bgzf", seed, tmp_path)
    text, factor = made["truth"]
    assert text == registry.load_module("makers", "shakespeare").base_text(
        registry.Bench().traffic("shakespeare-20x")["base"], seed)
    assert factor == 20 and made["bytes"] == 106000000
    with open(made["input"], "rb") as f:
        data = f.read()
    assert len(data) == made["stored_bytes"]
    assert not os.path.exists(made["input"] + ".gzi")
    assert data.endswith(EOF_MEMBER)
    plain = text.encode("ascii") * factor
    assert gzip.decompress(data) == plain
    members = _members(data)
    assert members[-1][2] == 0 and len(members) - 1 == (
        made["about"]["members"])
    at = 0
    for body, crc, isize in members[:-1]:
        piece = plain[at:at + isize]
        assert 0 < isize <= 65280
        assert zlib.decompress(body, -15) == piece
        assert crc == zlib.crc32(piece)
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
        assert body == c.compress(piece) + c.flush()
        at += isize
    assert at == len(plain)
    assert [m[2] for m in members[:-2]] == [65280] * (len(members) - 2)


def test_makers_import_nothing_of_the_port():
    """The yardstick's data stays independent of the code under test."""
    files = [os.path.join(PKG, "corpus.py")] + [
        os.path.join(PKG, "makers", n)
        for n in os.listdir(os.path.join(PKG, "makers"))
        if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "dampr_tpu_torch", "dampr_tpu", "jax", "tests"), (
                    path, m)


def test_write_copies_refuses_an_unknown_storage(tmp_path):
    with pytest.raises(ValueError):
        corpus.write_copies(str(tmp_path / "x"), b"a\n", 1, "zstd")
    with pytest.raises(ValueError):
        corpus.bgzf_member(b"a" * (corpus.BGZF_BLOCK + 1))
