"""Ingest of dampr_tpu_torch against the JAX package: the chunk planner,
gzip and BGZF taps, the readahead prefetcher and ``Dampr.urls``.

The port versions of ``tests/test_ingest.py``'s ``TestPlanner``,
``TestBgzf``, ``TestBgzfEdgeCases`` and ``TestReadahead``: each case runs
the same files (text made from a seed with numpy; BGZF written with the
htslib ``BC`` subfield and an EOF block by ``test_ingest.write_bgzf``)
through both packages and requires equal chunk plans, bytes and records.
``Dampr.urls`` reads from an ``http.server`` thread on 127.0.0.1 only.
Tolerance: exact.
"""

import functools
import gzip
import http.server
import operator
import os
import threading
import zlib

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import inputs as RI
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops.text import DocFreq as RefDocFreq
from dampr_tpu_torch import inputs as I
from dampr_tpu_torch import settings
from dampr_tpu_torch.ops.text import DocFreq

from test_ingest import _bgzf_member, write_bgzf

WORDS = ["alpha", "beta", "Gamma", "delta", "naïve", "tok7", "x9", "the"]


@pytest.fixture(autouse=True)
def knobs():
    old = (settings.device, settings.partitions,
           ref_settings.partitions, ref_settings.readahead_chunks)
    settings.device = "cpu"
    settings.partitions = ref_settings.partitions = 8
    yield
    (settings.device, settings.partitions,
     ref_settings.partitions, ref_settings.readahead_chunks) = old


def _text(seed, lines=300):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(lines):
        row = " ".join(WORDS[j] for j in rng.randint(0, len(WORDS),
                                                      rng.randint(0, 9)))
        out.append(row)
    return "\n".join(out) + "\n"


SAMPLE = _text(31)


def _write(tmp_path, name, text):
    p = str(tmp_path / name)
    with open(p, "w", encoding="utf-8") as f:
        f.write(text)
    return p


def _write_gzi(path):
    """A ``.gzi`` index of a BGZF file, from its member walk."""
    offs = []
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        off = 0
        while off < size:
            off += I._bgzf_member_size(f, off)
            if off < size:
                offs.append(off)
    with open(path + ".gzi", "wb") as f:
        f.write(len(offs).to_bytes(8, "little"))
        for o in offs:
            f.write(o.to_bytes(8, "little"))
            f.write((0).to_bytes(8, "little"))


def _plans(path, chunk_size):
    got = I.plan_chunks(path, chunk_size)
    want = RI.plan_chunks(path, chunk_size)
    assert [tuple(s) for s in got] == [tuple(s) for s in want]
    return got, want


def _bytes(specs, mod):
    return [mod._spec_dataset(s).read_bytes() for s in specs]


def _records(specs, mod):
    return [list(mod._spec_dataset(s).read()) for s in specs]


class TestPlanner:
    def test_plan_text_ranges(self, tmp_path):
        p = _write(tmp_path, "a.txt", SAMPLE)
        specs, _ = _plans(p, 1000)
        assert all(s.kind == "text" for s in specs)
        assert specs[0].start == 0 and specs[-1].end == os.path.getsize(p)

    def test_sniff_by_magic_not_extension(self, tmp_path):
        fake = _write(tmp_path, "fake.gz", SAMPLE)
        specs, _ = _plans(fake, 1000)
        assert len(specs) > 1 and all(s.kind == "text" for s in specs)
        real = str(tmp_path / "real.txt")  # gzip under a text name
        with gzip.open(real, "wt", encoding="utf-8") as f:
            f.write(SAMPLE)
        specs, _ = _plans(real, 10)
        assert [s.kind for s in specs] == ["gzip"]
        assert I._sniff(real) == RI._sniff(real) == "gzip"

    def test_walk_sorted_and_hides_dotfiles(self, tmp_path):
        d = tmp_path / "tree"
        (d / "sub").mkdir(parents=True)
        for name in ("b.txt", "a.txt", ".hidden", "sub/c.txt"):
            (d / name).write_text("x\n")
        assert (list(I.read_paths(str(d)))
                == list(RI.read_paths(str(d)))
                == [str(d / "a.txt"), str(d / "b.txt"),
                    str(d / "sub" / "c.txt")])


class TestBgzf:
    def test_detected_and_split(self, tmp_path):
        p = str(tmp_path / "x.bgzf.gz")
        write_bgzf(p, SAMPLE)
        assert I._sniff(p) == RI._sniff(p) == "bgzf"
        specs, _ = _plans(p, 300)
        assert all(s.kind == "bgzf" for s in specs) and len(specs) > 3

    @pytest.mark.parametrize("chunk_size", [100, 250, 1000, 10 ** 6])
    def test_chunks_cover_every_line_once(self, tmp_path, chunk_size):
        p = str(tmp_path / "x.gz")
        write_bgzf(p, SAMPLE, block_lines=3)
        specs, ref_specs = _plans(p, chunk_size)
        got = _bytes(specs, I)
        assert got == _bytes(ref_specs, RI)
        assert b"".join(got).decode("utf-8") == SAMPLE

    def test_read_lines_and_keys_match(self, tmp_path):
        p = str(tmp_path / "x.gz")
        write_bgzf(p, SAMPLE, block_lines=5)
        specs, ref_specs = _plans(p, 200)
        got = _records(specs, I)
        assert got == _records(ref_specs, RI)
        assert all(isinstance(k, int) for recs in got for k, _ in recs)
        assert [v for recs in got for _k, v in recs] == \
            SAMPLE.split("\n")[:-1]

    def test_line_crossing_member_boundaries(self, tmp_path):
        """One line spread over three members, split across chunks."""
        p = str(tmp_path / "long.gz")
        line = ("word " * 40).encode()
        with open(p, "wb") as f:
            f.write(_bgzf_member(b"head\n" + line[:50]))
            f.write(_bgzf_member(line[50:120]))
            f.write(_bgzf_member(line[120:] + b"\ntail\n"))
            f.write(_bgzf_member(b""))
        for chunk_size in (1, 40, 10 ** 6):
            specs, ref_specs = _plans(p, chunk_size)
            got = _bytes(specs, I)
            assert got == _bytes(ref_specs, RI)
            assert b"".join(got) == b"head\n" + line + b"\ntail\n"


class TestBgzfEdgeCases:
    def test_trailing_plain_gzip_member_falls_back_whole(self, tmp_path):
        p = str(tmp_path / "mixed.gz")
        with open(p, "wb") as f:
            f.write(_bgzf_member(b"a\nb\nc\nd\n"))
            f.write(_bgzf_member(b"e\nf\n"))
            f.write(gzip.compress(b"g\nh\n"))
        specs, _ = _plans(p, 10)
        assert [s.kind for s in specs] == ["gzip"]
        assert I._spec_dataset(specs[0]).read_bytes() == \
            b"a\nb\nc\nd\ne\nf\ng\nh\n"

    def test_gzi_index_plans_without_member_walk(self, tmp_path,
                                                 monkeypatch):
        p = str(tmp_path / "x.gz")
        write_bgzf(p, SAMPLE, block_lines=5)
        walk_specs, _ = _plans(p, 300)
        _write_gzi(p)

        def no_walk(f, off):
            raise AssertionError("planned by walking the members")

        with monkeypatch.context() as m:
            m.setattr(I, "_bgzf_member_size", no_walk)
            gzi_specs = I.plan_chunks(p, 300)
        assert [tuple(s) for s in gzi_specs] == [tuple(s) for s in
                                                 walk_specs]
        assert [tuple(s) for s in gzi_specs] == [
            tuple(s) for s in RI.plan_chunks(p, 300)]
        assert b"".join(_bytes(gzi_specs, I)).decode("utf-8") == SAMPLE

    def test_eof_block_owns_nothing(self, tmp_path):
        p = str(tmp_path / "x.gz")
        write_bgzf(p, SAMPLE, block_lines=50)
        specs, ref_specs = _plans(p, 1)  # one chunk per member
        got = _bytes(specs, I)
        assert got[-1] == b"" and got == _bytes(ref_specs, RI)

    def test_broken_symlink_ignored(self, tmp_path):
        d = tmp_path / "dir"
        d.mkdir()
        (d / "ok.txt").write_text("fine\n")
        os.symlink(str(tmp_path / "nonexistent"), str(d / "broken.txt"))
        assert list(I.read_paths(str(d) + "/*.txt")) == [str(d / "ok.txt")]


class TestGzipLineDataset:
    def test_one_chunk_records_and_blocks(self, tmp_path):
        from dampr_tpu.dataset import GzipLineDataset as RefGzip
        from dampr_tpu_torch.dataset import GzipLineDataset

        p = str(tmp_path / "plain.gz")
        with gzip.open(p, "wt", encoding="utf-8") as f:
            f.write(SAMPLE)
        ds, ref = GzipLineDataset(p), RefGzip(p)
        assert list(ds.read()) == list(ref.read())
        assert ds.read_bytes() == ref.read_bytes() == SAMPLE.encode()
        assert (list(ds.iter_byte_blocks(1000))
                == list(ref.iter_byte_blocks(1000)))


def _doc_freq(pkg, DF, path, chunk):
    return (pkg.Dampr.text(path, chunk)
            .custom_mapper(DF(mode="word", lower=True, pair_values=False))
            .fold_values(operator.add))


def _word_counts(pkg, path, chunk):
    return pkg.Dampr.text(path, chunk).flat_map(str.split).count()


class TestTextOverCompressedFiles:
    """``Dampr.text`` over plain gzip and BGZF (with and without ``.gzi``)
    reads back the JAX package's records, and the plain text's."""

    @pytest.fixture
    def corpora(self, tmp_path):
        text = _text(32, lines=2000)
        plain = _write(tmp_path, "plain.txt", text)
        gz = str(tmp_path / "plain.gz")
        with gzip.open(gz, "wt", encoding="utf-8") as f:
            f.write(text)
        bg = str(tmp_path / "blocked.gz")
        write_bgzf(bg, text, block_lines=37)
        bgi = str(tmp_path / "indexed.gz")
        write_bgzf(bgi, text, block_lines=37)
        _write_gzi(bgi)
        return {"plain": plain, "gzip": gz, "bgzf": bg, "bgzf_gzi": bgi}

    @pytest.mark.parametrize("kind", ["gzip", "bgzf", "bgzf_gzi"])
    def test_records_equal_the_jax_package(self, corpora, kind):
        path = corpora[kind]
        chunk = 4096
        want = _word_counts(dampr_tpu, path, chunk).read()
        assert _word_counts(dampr_tpu_torch, path, chunk).read() == want
        assert want == _word_counts(dampr_tpu, corpora["plain"], 2048).read()
        rows = dampr_tpu_torch.Dampr.text(path, chunk).read()
        assert rows == dampr_tpu.Dampr.text(path, chunk).read()

    @pytest.mark.parametrize("kind", ["gzip", "bgzf"])
    @pytest.mark.parametrize("lower", ["0", "1"])
    def test_doc_freq_equals_the_jax_package(self, corpora, kind, lower):
        settings.lower = lower
        try:
            got = _doc_freq(dampr_tpu_torch, DocFreq, corpora[kind],
                            4096).read()
        finally:
            settings.lower = "auto"
        assert got == _doc_freq(dampr_tpu, RefDocFreq, corpora[kind],
                                4096).read()


def _joined(ra):
    ra._thread.join(5)
    assert not ra._thread.is_alive()


class TestReadahead:
    def test_prefetch_matches_direct(self, tmp_path, monkeypatch):
        p = _write(tmp_path, "a.txt", SAMPLE)
        monkeypatch.setattr(I, "READAHEAD_CHUNKS", 2)
        chunks = list(I.PathInput(p, chunk_size=400).chunks())
        assert all(isinstance(c, I.PrefetchedChunk) for c in chunks)
        direct = list(RI.TextInput(p, chunk_size=400).chunks())
        assert [c.read_bytes() for c in chunks] == [
            d.read_bytes() for d in direct]
        _joined(chunks[0]._readahead)

    def test_out_of_order_take(self):
        loads = [lambda i=i: b"chunk%d" % i for i in range(6)]
        ra = I.Readahead(loads, depth=2)
        assert [ra.take(i) for i in (3, 0, 5, 1, 2, 4)] == [
            b"chunk%d" % i for i in (3, 0, 5, 1, 2, 4)]
        _joined(ra)

    def test_inflight_load_is_waited_not_duplicated(self):
        calls = []
        gate = threading.Event()
        started = threading.Event()

        def slow0():
            calls.append(0)
            started.set()
            assert gate.wait(5)
            return b"zero"

        ra = I.Readahead([slow0, lambda: b"one"], depth=1)
        # the first take starts the prefetch thread, which loads 0 while
        # this thread claims and loads 1 itself
        assert ra.take(1) == b"one"
        assert started.wait(5)  # the thread is inside loader 0
        got = []
        t = threading.Thread(target=lambda: got.append(ra.take(0)))
        t.start()
        gate.set()
        t.join(5)
        assert not t.is_alive()
        assert got == [b"zero"] and calls == [0]
        _joined(ra)

    def test_loader_error_propagates(self):
        def boom():
            raise IOError("disk gone")

        ra = I.Readahead([boom], depth=1)
        with pytest.raises(IOError):
            ra.take(0)
        _joined(ra)

    def test_zero_depth_disables(self, tmp_path, monkeypatch):
        p = _write(tmp_path, "a.txt", SAMPLE)
        monkeypatch.setattr(I, "READAHEAD_CHUNKS", 0)
        chunks = list(I.PathInput(p, chunk_size=400).chunks())
        assert not any(isinstance(c, I.PrefetchedChunk) for c in chunks)

    def test_close_stops_a_thread_whose_chunks_were_never_taken(self):
        """A consumer that takes one chunk of six leaves the thread
        waiting for a free slot; close() ends it, drops what it loaded,
        and a later take raises."""
        ra = I.Readahead([lambda i=i: b"c%d" % i for i in range(6)],
                         depth=2)
        assert ra.take(0) == b"c0"
        ra.close()
        assert not ra._thread.is_alive()
        assert ra._results == {}
        with pytest.raises(RuntimeError):
            ra.take(3)

    def test_close_during_a_load_drops_its_result(self):
        gate = threading.Event()
        started = threading.Event()

        def slow():
            started.set()
            assert gate.wait(5)
            return b"late"

        ra = I.Readahead([lambda: b"a", slow], depth=2)
        assert ra.take(0) == b"a"
        assert started.wait(5)  # the thread is inside loader 1
        closer = threading.Thread(target=ra.close)
        closer.start()
        gate.set()
        closer.join(5)
        assert not closer.is_alive()
        assert not ra._thread.is_alive() and ra._results == {}

    def test_a_stage_closes_its_readahead(self, tmp_path, monkeypatch):
        """The runner closes the readahead behind a stage's chunks when
        the stage ends, and when it fails (here a chunk that does not
        inflate), with the thread stopped either way."""
        p = str(tmp_path / "x.gz")
        write_bgzf(p, SAMPLE, block_lines=3)
        monkeypatch.setattr(I, "READAHEAD_CHUNKS", 2)
        made = []
        real = I.Readahead

        def tracked(*a, **k):
            made.append(real(*a, **k))
            return made[-1]

        monkeypatch.setattr(I, "Readahead", tracked)
        got = _doc_freq(dampr_tpu_torch, DocFreq, p, 300).read()
        assert got == _doc_freq(dampr_tpu, RefDocFreq, p, 300).read()
        assert made and all(ra._closed for ra in made)
        assert any(ra._thread is not None for ra in made)
        assert not any(ra._thread and ra._thread.is_alive() for ra in made)

        def corrupt(_raw):
            raise zlib.error("corrupt member")

        del made[:]
        monkeypatch.setattr(I.BgzfChunkDataset, "_inflate",
                            staticmethod(corrupt))
        with pytest.raises(zlib.error):
            _doc_freq(dampr_tpu_torch, DocFreq, p, 300).read()
        assert made and all(ra._closed for ra in made)
        assert not any(ra._thread and ra._thread.is_alive() for ra in made)


class _Quiet(http.server.SimpleHTTPRequestHandler):
    def log_message(self, *args):
        pass


@pytest.fixture
def http_root(tmp_path):
    """An ``http.server`` on 127.0.0.1 serving ``tmp_path``; yields its
    base URL and joins the server thread after the test."""
    server = http.server.ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(_Quiet,
                                            directory=str(tmp_path)))
    t = threading.Thread(target=server.serve_forever, args=(0.05,),
                         daemon=True)
    t.start()
    try:
        yield tmp_path, "http://127.0.0.1:{}/".format(server.server_port)
    finally:
        server.shutdown()
        server.server_close()
        t.join(5)
        assert not t.is_alive()


class TestUrls:
    def test_urls_equal_the_jax_package(self, http_root):
        root, base = http_root
        names = []
        for i in range(3):
            names.append("doc%d.txt" % i)
            _write(root, names[-1], _text(40 + i, lines=50))
        urls = [base + n for n in names] + [base + "missing.txt"]

        def pipe(pkg):
            return (pkg.Dampr.urls(urls).flat_map(str.split).count())

        want = pipe(dampr_tpu).read()
        assert pipe(dampr_tpu_torch).read() == want and want
        assert (dampr_tpu_torch.Dampr.urls(urls[:1]).read()
                == dampr_tpu.Dampr.urls(urls[:1]).read())

    def test_url_error_raises_unless_skipped(self, http_root):
        from urllib.error import HTTPError

        _root, base = http_root
        with pytest.raises(HTTPError):
            dampr_tpu_torch.Dampr.urls([base + "missing.txt"],
                                       skip_on_error=False).read()
        assert dampr_tpu_torch.Dampr.urls([base + "missing.txt"]).read() \
            == []
