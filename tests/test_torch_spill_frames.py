"""The chunked-frame spill format of dampr_tpu_torch (``io/``, ``storage``):
round trips across codecs, bounded windows, the hash and composite lanes,
truncation, prefetched against serial reads, random access, and files
written by either package read back in the other.

The cases are ``tests/test_spill_frames.py``'s, on blocks made from a
seed with numpy; every comparison is exact.  The legacy (pre-frame)
formats are not ported: the port never wrote them, so a non-frame file
raises ``FrameFormatError``.
"""

import os
import pickle

import numpy as np
import pytest

import dampr_tpu.storage as ref_storage
from dampr_tpu import settings as ref_settings
from dampr_tpu.blocks import Block as RefBlock
from dampr_tpu_torch import settings, storage
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.io import codecs, frames
from dampr_tpu_torch.io.frames import FrameFormatError, FrameReader
from dampr_tpu_torch.storage import (SPILL_WINDOW, iter_block_windows,
                                     load_block, save_block)


def _assert_blocks_equal(a, b):
    assert len(a) == len(b)
    assert list(a.iter_pairs()) == list(b.iter_pairs())


def _object_block(n=SPILL_WINDOW + 777, seed=0):
    rng = np.random.RandomState(seed)
    ks = np.empty(n, dtype=object)
    ks[:] = ["key-%d" % k for k in rng.randint(0, 997, size=n)]
    vs = np.empty(n, dtype=object)
    vs[:] = [("v", int(i)) for i in rng.randint(0, 1 << 30, size=n)]
    return Block(ks, vs)


def _numeric_block(n=2 * SPILL_WINDOW + 31, seed=1):
    rng = np.random.RandomState(seed)
    blk = Block(rng.randint(-2 ** 62, 2 ** 62, size=n).astype(np.int64),
                rng.rand(n))
    blk.hashes()
    return blk


@pytest.fixture(autouse=True)
def on_the_cpu():
    old = settings.device
    settings.device = "cpu"
    yield
    settings.device = old


def _frame_codec_ids(path):
    r = FrameReader(path)
    try:
        return {e[1] for e in r.index}
    finally:
        r.close()


class TestRoundTrip:
    @pytest.mark.parametrize("make", [_numeric_block, _object_block])
    def test_save_load_exact(self, tmp_path, make):
        blk = make()
        p = str(tmp_path / "b.blk")
        save_block(blk, p)
        _assert_blocks_equal(load_block(p), blk)

    def test_windows_are_bounded(self, tmp_path):
        blk = _numeric_block(3 * SPILL_WINDOW + 5)
        p = str(tmp_path / "b.blk")
        save_block(blk, p)
        ws = list(iter_block_windows(p))
        assert len(ws) == 4
        assert all(len(w) <= SPILL_WINDOW for w in ws)
        _assert_blocks_equal(Block.concat(ws), blk)

    def test_empty_block(self, tmp_path):
        blk = Block(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64))
        p = str(tmp_path / "e.blk")
        save_block(blk, p)
        assert len(load_block(p)) == 0
        # still a frame file, with one (empty) frame
        r = FrameReader(p)
        try:
            assert len(r) == 1 and r.records == 0
        finally:
            r.close()

    def test_hash_lanes_survive(self, tmp_path):
        blk = _numeric_block()
        p = str(tmp_path / "h.blk")
        save_block(blk, p)
        back = load_block(p)
        assert np.array_equal(back.h1, blk.h1)
        assert np.array_equal(back.h2, blk.h2)

    def test_composite_lane_round_trip(self, tmp_path):
        rng = np.random.RandomState(2)
        n = SPILL_WINDOW + 9
        blk = Block(np.arange(n, dtype=np.int64),
                    rng.randint(0, 1000, size=(n, 2)).astype(np.int64))
        p = str(tmp_path / "c.blk")
        save_block(blk, p)
        assert np.array_equal(load_block(p).values, blk.values)


class TestCodecs:
    @pytest.mark.parametrize("name", ["raw", "zlib", "gzip", "zlib:6"])
    def test_explicit_codec_round_trip(self, tmp_path, name):
        blk = _object_block(SPILL_WINDOW // 2)
        p = str(tmp_path / "c.blk")
        save_block(blk, p, codecs.resolve(name))
        _assert_blocks_equal(load_block(p), blk)

    def test_optional_codecs_round_trip_or_fall_back(self, tmp_path):
        # installed: the codec itself; missing: the fallback, readable
        for name in ("lz4", "zstd"):
            blk = _object_block(SPILL_WINDOW // 4)
            p = str(tmp_path / (name + ".blk"))
            save_block(blk, p, codecs.resolve(name))
            _assert_blocks_equal(load_block(p), blk)
            cids = _frame_codec_ids(p)
            if codecs.available(name):
                assert cids == {codecs._IDS[name]}
            else:
                assert codecs._IDS[name] not in cids

    def test_mixed_codecs_coexist_in_one_dir(self, tmp_path):
        blocks, paths = [], []
        # None: the spill policy's own choice
        for i, name in enumerate(["raw", "zlib", "gzip", "auto", None]):
            blk = _object_block(SPILL_WINDOW // 8 + i, seed=i)
            p = str(tmp_path / ("m%d.blk" % i))
            save_block(blk, p, name and codecs.resolve(name))
            blocks.append(blk)
            paths.append(p)
        for blk, p in zip(blocks, paths):
            _assert_blocks_equal(load_block(p), blk)

    def test_missing_codec_decode_raises(self, tmp_path):
        class FutureCodec(object):  # a codec id this build doesn't know
            cid = 99

            def compress(self, data):
                return data

        p = str(tmp_path / "bad.blk")
        with open(p, "wb") as f:
            w = frames.FrameWriter(f, FutureCodec())
            w.add_frame(b"payload", records=1)
            w.close()
        r = FrameReader(p)
        try:
            with pytest.raises(codecs.MissingCodecError):
                r.read_frame(0)
        finally:
            r.close()

    def test_auto_resolves_and_explicit_levels_parse(self):
        assert codecs.resolve("auto").name in ("zstd", "lz4", "zlib")
        assert codecs.resolve("zlib:7").level == 7
        with pytest.raises(ValueError):
            codecs.resolve("nonsense")

    def test_fallback_drops_foreign_level(self):
        # "zstd:19" where zstd is missing must not become zlib:19
        c = codecs.resolve("zstd:19")
        if c.name != "zstd":
            assert c.name in ("lz4", "zlib")
        data = b"x" * 4096
        assert c.decompress(c.compress(data)) == data

    def test_policy_spills_numeric_raw_and_object_lanes_compressed(
            self, tmp_path):
        want = codecs.resolve(storage.SPILL_CODEC, storage.COMPRESS_LEVEL)
        assert want.name in ("zstd", "lz4", "zlib")
        for make, cid in ((_numeric_block, codecs.RAW),
                          (_object_block, want.cid)):
            blk = make()
            p = str(tmp_path / (make.__name__ + ".blk"))
            save_block(blk, p)
            assert _frame_codec_ids(p) == {cid}
            _assert_blocks_equal(load_block(p), blk)


class TestTruncation:
    def _frame_file(self, tmp_path):
        p = str(tmp_path / "t.blk")
        save_block(_numeric_block(), p)
        return p

    def test_truncated_footer_raises(self, tmp_path):
        p = self._frame_file(tmp_path)
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) - 7)  # clip the trailer
        with pytest.raises(FrameFormatError, match="trailer|truncated"):
            list(iter_block_windows(p))

    def test_truncated_mid_frames_raises(self, tmp_path):
        p = self._frame_file(tmp_path)
        with open(p, "r+b") as f:
            f.truncate(os.path.getsize(p) // 2)
        with pytest.raises(FrameFormatError):
            list(iter_block_windows(p))

    def test_corrupt_footer_pickle_raises(self, tmp_path):
        p = self._frame_file(tmp_path)
        size = os.path.getsize(p)
        with open(p, "r+b") as f:
            f.seek(size - 20)
            f.write(b"\xff" * 8)
        with pytest.raises(FrameFormatError):
            FrameReader(p)

    @pytest.mark.parametrize("head", [b"\x1f\x8b", b"\x80\x05", b""])
    def test_a_non_frame_file_raises(self, tmp_path, head):
        p = str(tmp_path / "old.blk")
        with open(p, "wb") as f:
            f.write(head + pickle.dumps((1, 2, None, None)))
        with pytest.raises(FrameFormatError, match="not a frame"):
            list(iter_block_windows(p))


class TestParallelDecode:
    def test_prefetch_matches_serial(self, tmp_path):
        blk = _object_block(6 * SPILL_WINDOW + 13)
        p = str(tmp_path / "par.blk")
        save_block(blk, p)
        serial = Block.concat(list(iter_block_windows(p, prefetch=0)))
        parallel = Block.concat(list(iter_block_windows(p, prefetch=4)))
        _assert_blocks_equal(serial, parallel)
        _assert_blocks_equal(parallel, blk)

    def test_abandoned_prefetch_iterator_is_safe(self, tmp_path):
        p = str(tmp_path / "ab.blk")
        save_block(_numeric_block(8 * SPILL_WINDOW), p)
        it = iter_block_windows(p, prefetch=4)
        assert len(next(it)) == SPILL_WINDOW
        it.close()  # abandoned mid-stream: no fd leak, no crash

    def test_random_access_read_frame(self, tmp_path):
        blk = _numeric_block(4 * SPILL_WINDOW)
        p = str(tmp_path / "ra.blk")
        save_block(blk, p)
        r = FrameReader(p)
        try:
            assert len(r) == 4
            keys, _v, _h1, _h2 = frames.load_window_payload(r.read_frame(3))
            assert np.array_equal(
                keys, blk.keys[3 * SPILL_WINDOW:4 * SPILL_WINDOW])
        finally:
            r.close()


@pytest.mark.parametrize("kind", ["numeric", "object", "composite"])
@pytest.mark.parametrize("compress", ["auto", "always", "zlib:6"])
def test_each_package_reads_the_others_files(tmp_path, kind, compress):
    """A block saved by ``dampr_tpu.storage.save_block`` streams back through
    the port's ``iter_block_windows`` and the reverse, every lane equal
    (the codec each side picks for "auto"/"always" is its own; the port's
    "auto" is its spill policy, "always" its policy's codec on every
    block)."""
    rng = np.random.RandomState(3)
    n = 2 * SPILL_WINDOW + 101
    keys = rng.randint(0, 1 << 40, size=n).astype(np.int64)
    if kind == "numeric":
        values = rng.rand(n)
    elif kind == "object":
        keys = np.array(["k%d" % k for k in keys], dtype=object)
        values = np.empty(n, dtype=object)
        values[:] = [(int(a), "s%d" % a) for a in rng.randint(0, 99, n)]
    else:
        values = rng.randint(0, 1 << 20, size=(n, 2)).astype(np.int64)
    old = ref_settings.spill_compress
    ref_settings.spill_compress = compress
    codec = {"auto": None,
             "always": codecs.resolve(storage.SPILL_CODEC,
                                      storage.COMPRESS_LEVEL),
             "zlib:6": codecs.resolve("zlib:6")}[compress]
    try:
        ref_blk = RefBlock(keys, values)
        ref_blk.hashes()
        port_blk = Block(keys, values, ref_blk.h1, ref_blk.h2)
        ref_path = str(tmp_path / "ref.blk")
        port_path = str(tmp_path / "port.blk")
        ref_storage.save_block(ref_blk, ref_path)
        save_block(port_blk, port_path, codec)
        for got in (Block.concat(list(iter_block_windows(ref_path))),
                    ref_storage.load_block(port_path)):
            for lane in ("keys", "values", "h1", "h2"):
                a, b = getattr(got, lane), getattr(ref_blk, lane)
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a, b)
    finally:
        ref_settings.spill_compress = old
