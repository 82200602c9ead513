"""The lowered sink's compact feed against the JAX package's host padding.

The port's sink scans a window into compact token lanes
(``ops.lower.scan_lanes``), uploads each batch as the byte span its tokens
cover with offsets, lengths and lines, and builds the padded rows on the
program's device (``ops.fnv.build_rows``; on CPU tensors its plain torch
version).  Those rows must equal, bit for bit, the padded matrix the JAX
package's sink builds on the host (``dampr_tpu.ops.lower
.DeviceTokenFoldSink._pad_batch``) from the host scan
(``dampr_tpu.ops.text._token_bounds``, the sink's ``_line_ids``), with the
same tokens and the same batch cut points.  Tolerance: exact.
"""

import collections
import re
import tracemalloc

import numpy as np
import pytest
import torch

from dampr_tpu import settings as ref_settings
from dampr_tpu.ops import lower as ref_lower
from dampr_tpu.ops import text as ref_text
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.ops import fnv as port_fnv
from dampr_tpu_torch.ops import lower as port_lower
from dampr_tpu_torch.ops import text as port_text


@pytest.fixture(autouse=True)
def cpu_device():
    old = (port_settings.device, port_settings.lower_batch,
           ref_settings.lower_pallas_segfold)
    port_settings.device = "cpu"
    ref_settings.lower_pallas_segfold = False
    yield
    (port_settings.device, port_settings.lower_batch,
     ref_settings.lower_pallas_segfold) = old


def _params(mode="word", lower=True, dedup=True):
    return {"mode": mode, "lower": lower, "dedup": dedup,
            "pair_values": False}


def _host_scan(buf, mode, dedup):
    """The JAX package's scan: every short token's int64 start, int32
    length and line, in window order."""
    starts, lens = ref_text._token_bounds(buf, mode)
    lines = _ref_line_ids(buf, starts) if dedup else None
    keep = lens <= ref_text._SHORT_TOKEN
    return (starts[keep], lens[keep],
            lines[keep] if lines is not None else None)


def _ref_line_ids(buf, starts):
    return ref_lower.DeviceTokenFoldSink(_params())._line_ids(buf, starts)


def _host_rows(buf, starts, lens, lines):
    """The JAX package's padded batch (its sink's ``_pad_batch``)."""
    return ref_lower.DeviceTokenFoldSink(_params())._pad_batch(
        buf, starts, lens, lines)


def _assert_rows_equal(rows, want):
    for got, exp in zip(rows, want):
        np.testing.assert_array_equal(got.numpy(), exp)


def _window(max_len, n_lines, seed, trailing_newline):
    """A window whose longest token is ``max_len`` bytes, a token at its
    first byte and (without the trailing newline) at its last."""
    rng = np.random.RandomState(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    lines = []
    for i in range(n_lines):
        words = []
        for _ in range(rng.randint(0, 9)):
            w = letters[rng.randint(0, 26, size=rng.randint(1, 9))]
            words.append(w.tobytes().decode())
        if i == n_lines // 2:
            words.append("q" * max_len)
        lines.append(" ".join(words) + rng.choice(["", ",", ".", "  "]))
    text = "\n".join(lines)
    text = "Tok " + text + (" end\n" if trailing_newline else " end")
    return text.encode()


ROW_CASES = [
    # (longest token -> L bucket, lines given, batch of the window)
    (5, True, "all"), (13, True, "all"), (30, False, "all"),
    (30, True, "middle"), (60, True, "head"), (100, False, "tail"),
    (255, True, "all"), (255, False, "middle")]


class TestRowBuilder:
    @pytest.mark.parametrize("max_len,with_lines,part", ROW_CASES)
    def test_plain_builder_matches_host_padding(self, max_len, with_lines,
                                                part):
        data = _window(max_len, 389, max_len, trailing_newline=False)
        buf = np.frombuffer(data, dtype=np.uint8)
        starts, lens, lines = _host_scan(buf, "word", True)
        assert starts[0] == 0 and starts[-1] + lens[-1] == len(buf)
        n = len(starts)
        a, b = {"all": (0, n), "head": (0, n // 3),
                "middle": (n // 3, 2 * n // 3), "tail": (n // 2, n)}[part]
        starts, lens, lines = starts[a:b], lens[a:b], lines[a:b]
        assert len(starts) & (len(starts) - 1)  # pad rows follow
        if not with_lines:
            lines = None
        want = _host_rows(buf, starts, lens, lines)
        assert want[0].shape[1] == port_lower._len_bucket(lens.max())
        # the compact upload, fed to the plain builder
        s0, s1 = int(starts[0]), int(starts[-1] + lens[-1])
        rows = port_fnv.build_rows(
            torch.from_numpy(buf[s0:s1].copy()),
            torch.from_numpy((starts - s0).astype(np.int32)),
            torch.from_numpy(lens.astype(np.uint8)),
            None if lines is None else torch.from_numpy(lines),
            want[0].shape[0], want[0].shape[1])
        _assert_rows_equal(rows, want)
        # and through the sink's own staging
        sink = port_lower.DeviceTokenFoldSink(_params(dedup=with_lines))
        _assert_rows_equal(sink._pad_batch(buf, starts.astype(np.int32),
                                           lens.astype(np.uint8), lines),
                           want)
        assert sink.card_rows_batches == 1 and sink.staging_allocs == 1

    def test_builder_refuses_what_the_kernel_does_not_take(self):
        span = torch.zeros(16, dtype=torch.uint8)
        offs = torch.zeros(2, dtype=torch.int32)
        lens = torch.ones(2, dtype=torch.uint8)
        with pytest.raises(ValueError):
            port_fnv.build_rows(span, offs, lens.to(torch.int32), None, 2, 8)
        with pytest.raises(ValueError):
            port_fnv.build_rows(span, offs, lens, None, 1, 8)
        with pytest.raises(ValueError):
            port_fnv.build_rows(span, offs, lens, None, 2, 12)


SCAN_CASES = [
    ("word", True, _window(30, 700, 3, trailing_newline=True)),
    ("word", False, _window(255, 300, 4, trailing_newline=False)),
    ("whitespace", True, _window(20, 500, 5, trailing_newline=True)),
    # long tokens (over 255 bytes) between short ones, a blank first line
    ("word", True, ("\n" + "a" * 300 + " b c\n" + "d " * 50 + "e" * 256
                    + "\nf\n").encode()),
    ("whitespace", False, ("x" * 400 + "\n\n y z " + "w" * 700).encode()),
    # multibyte tokens
    ("word", True, "naïve café 日本語\nÉcole x\n".encode() * 40)]


class TestScanLanes:
    @pytest.mark.parametrize("case", range(len(SCAN_CASES)))
    @pytest.mark.parametrize("slice_bytes", [64, 1000, 1 << 20])
    def test_lanes_match_host_scan(self, case, slice_bytes):
        mode, dedup, data = SCAN_CASES[case]
        buf = np.frombuffer(data, dtype=np.uint8)
        cuts = port_lower.scan_slices(buf, slice_bytes)
        assert cuts[0][0] == 0 and cuts[-1][1] == len(buf)
        assert all(data[b - 1:b] == b"\n" for _a, b in cuts[:-1])
        starts, lens, lines, long = port_lower.scan_lanes(buf, mode, dedup,
                                                          cuts)
        assert (starts.dtype, lens.dtype) == (np.int32, np.uint8)
        all_s, all_l = ref_text._token_bounds(buf, mode)
        all_li = _ref_line_ids(buf, all_s)
        short = all_l <= ref_text._SHORT_TOKEN
        np.testing.assert_array_equal(starts, all_s[short])
        np.testing.assert_array_equal(lens, all_l[short])
        if dedup:
            assert lines.dtype == np.int32
            np.testing.assert_array_equal(lines, all_li[short])
        else:
            assert lines is None
        if short.all():
            assert long is None
        else:
            np.testing.assert_array_equal(long[0], all_s[~short])
            np.testing.assert_array_equal(long[1], all_l[~short])
            if dedup:
                np.testing.assert_array_equal(long[2], all_li[~short])


# ---------------------------------------------------------------------------
# One producer's window of a Shakespeare-sized corpus, through the sink
# ---------------------------------------------------------------------------

#: Distinct words by length (letters: count), the shape of Shakespeare's
#: lower-cased vocabulary (23,903 words).
_WORD_LENGTHS = {1: 3, 2: 60, 3: 420, 4: 1500, 5: 2801, 6: 3600, 7: 3900,
                 8: 3700, 9: 3100, 10: 2200, 11: 1300, 12: 700, 13: 350,
                 14: 160, 15: 65, 16: 25, 17: 10, 18: 4, 19: 2, 20: 1,
                 22: 1, 27: 1}

#: Bytes of one producer's window: a 106 MB corpus over 8 producers.
_WINDOW_BYTES = 13_250_000


def _shakespeare_like(seed, nbytes):
    """Lines of 1-13 words drawn by a Zipf law over the vocabulary above
    (shorter words ranked higher), most indented, some capitalised, with commas and end marks; a 1.3 MB
    base repeated to ``nbytes`` and cut after its last newline."""
    rng = np.random.RandomState(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    lengths = np.repeat(list(_WORD_LENGTHS), list(_WORD_LENGTHS.values()))
    # the short words are the common ones
    lengths = lengths[np.argsort(np.log(lengths)
                                 + rng.normal(0, 0.5, len(lengths)))]
    vocab = [letters[rng.randint(0, 26, size=k)].tobytes().decode()
             for k in lengths.tolist()]
    p = 1.0 / (np.arange(len(vocab)) + 12.0) ** 1.4
    ids = rng.choice(len(vocab), size=220_000, p=p / p.sum()).tolist()
    ends = ["", ",", ".", ";", "!", "?", ":"]
    lines, at = [], 0
    while at < len(ids):
        k = rng.randint(1, 14)
        words = [vocab[i] for i in ids[at:at + k]]
        at += k
        words[0] = words[0].capitalize()
        if rng.rand() < 0.08:
            words[-1] += ","
        line = " ".join(words) + ends[rng.randint(0, len(ends))]
        if rng.rand() < 0.03:
            line = line.upper()
        if rng.rand() < 0.858:
            line = "     " + line
        lines.append(line)
        if rng.rand() < 0.05:
            lines.append("")
    base = ("\n".join(lines) + "\n").encode()
    data = (base * (nbytes // len(base) + 1))[:nbytes]
    return data[:data.rfind(b"\n") + 1]


@pytest.fixture(scope="module")
def corpus_window():
    """One producer's 13.25 MB line-aligned window of Shakespeare-shaped
    text."""
    return _shakespeare_like(7, _WINDOW_BYTES)


@pytest.fixture
def one_thread():
    """The window's plain-torch program on one thread: the suite's workers
    share the host's cores, and torch's own threads would crowd them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _docfreq(data):
    d = collections.Counter()
    for line in data.decode().lower().split("\n"):
        d.update(set(t for t in re.split(r"[^\w]+", line) if t))
    return d


class TestSinkWindow:
    def test_corpus_window_batches_equal_the_host_algorithm(
            self, corpus_window, one_thread, monkeypatch):
        data = corpus_window
        assert len(data) > 13_000_000
        # the JAX package's scan and cut points
        buf = ref_text._LOWER[np.frombuffer(data, dtype=np.uint8)]
        starts, lens, lines = _host_scan(buf, "word", True)
        bounds = ref_lower._batch_bounds(
            lines, len(starts), max(1024, port_settings.lower_batch))
        assert len(bounds) > 1
        seen = []
        real = port_lower.token_fold

        def checked(mat, lens_t, lines_t, dedup, **kw):
            a, b = bounds[len(seen)]
            _assert_rows_equal((mat, lens_t, lines_t), _host_rows(
                buf, starts[a:b], lens[a:b], lines[a:b]))
            seen.append((a, b))
            return real(mat, lens_t, lines_t, dedup, **kw)

        monkeypatch.setattr(port_lower, "token_fold", checked)
        sink = port_lower.device_window_sink(port_text.DocFreq(
            mode="word", lower=True, pair_values=False))
        got = collections.Counter()
        for blk in list(sink.add(memoryview(data))) + list(sink.finish()):
            for k, v in zip(blk.keys, blk.values):
                got[k] += int(v)
        assert seen == bounds
        assert sink.batches == len(bounds) and sink.fallbacks == 0
        assert sink.card_rows_batches == sink.batches
        assert sink.staging_allocs <= port_lower.RING_SLOTS
        assert got == _docfreq(data)

    def test_corpus_window_numpy_peak(self, corpus_window, one_thread):
        """The host's numpy peak of one window through the sink: the
        lowered copy, the compact lanes and one slice's temporaries (the
        host padding of the JAX package's design peaks near 165 MB on
        this window)."""
        sink = port_lower.device_window_sink(port_text.DocFreq(
            mode="word", lower=True, pair_values=False))
        win = memoryview(corpus_window)
        tracemalloc.start()
        try:
            blocks = sink.add(win)
            peak = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        assert len(blocks) == sink.batches > 1
        assert peak < 70e6, peak
