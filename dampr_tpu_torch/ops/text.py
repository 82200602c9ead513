"""Vectorized text scanners: raw chunk bytes -> folded (token, count) blocks.

Port of ``dampr_tpu/ops/text.py`` (the byte tables, the scanners and the
window driver the lowered stage shares).  A chunk's bytes become a uint8
array, token bounds come from table lookups, and counting groups tokens by
their bytes; token *strings* materialize only for the distinct keys.

- :class:`TokenCounts` — (token, occurrences).
- :class:`DocFreq` — (token, number of lines containing it).
- :class:`CountRecords` — the ``len()`` map, one (1, count) per chunk.
- :class:`ParseNumbers` — one number a line, keyed by its value (the
  external sort's map).

'word' mode matches ``re.split(r'[^\\w]+')`` and ``.lower()`` byte-wise,
exact for ASCII; non-ASCII bytes ride inside tokens.
"""

import numpy as np

from ..base import Mapper, _one_input
from . import devtime
from . import hashing

# --- byte classification tables -------------------------------------------

_WS = np.zeros(256, dtype=bool)
for _b in b" \t\n\r\x0b\x0c":
    _WS[_b] = True

_WORD = np.zeros(256, dtype=bool)
for _b in range(256):
    c = chr(_b)
    if c.isalnum() and _b < 128 or c == "_":
        _WORD[_b] = True
_WORD[128:] = True  # utf-8 continuation/lead bytes ride inside tokens

_LOWER = np.arange(256, dtype=np.uint8)
_LOWER[65:91] += 32  # A-Z -> a-z


def _token_bounds(buf, mode):
    """starts[int64], lens[int32] of maximal token runs in a uint8 buffer."""
    if mode == "word":
        in_tok = _WORD[buf]
    else:
        in_tok = ~_WS[buf]
    if not len(buf):
        return np.empty(0, np.int64), np.empty(0, np.int32)
    change = np.empty(len(buf) + 1, dtype=bool)
    change[0] = in_tok[0]
    np.not_equal(in_tok[1:], in_tok[:-1], out=change[1:-1])
    change[-1] = in_tok[-1]
    bounds = np.flatnonzero(change)
    starts = bounds[0::2].astype(np.int64)
    ends = bounds[1::2].astype(np.int64)
    return starts, (ends - starts).astype(np.int32)


# Tokens at most this long go through the padded-matrix paths; longer ones
# (rare in text) are counted in a host dict so the matrix stays bounded.
_SHORT_TOKEN = 255


def group_token_rows(buf, starts, lens, lines, dedup):
    """Exact host grouping of tokens by their bytes: length-prefixed byte
    rows through ``np.unique`` (colliding hashes can never merge distinct
    tokens), per-line first-occurrence dedup when ``dedup``.  Returns
    ``(uniq_rows, counts)``; ``uniq_rows[i, 0]`` is the token length."""
    n = len(starts)
    L = int(lens.max())
    idx = starts[:, None] + np.arange(L, dtype=np.int64)[None, :]
    np.clip(idx, 0, len(buf) - 1, out=idx)
    mat = np.where(np.arange(L, dtype=np.int32)[None, :]
                   < lens[:, None], buf[idx], 0)
    rows = np.empty((n, L + 1), dtype=np.uint8)
    rows[:, 0] = lens
    rows[:, 1:] = mat
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    if dedup:
        combined = lines.astype(np.int64) * len(uniq) + inverse
        uc = np.unique(combined)
        counts = np.bincount(uc % len(uniq), minlength=len(uniq))
    else:
        counts = np.bincount(inverse, minlength=len(uniq))
    return uniq, counts


def line_ids(buf, starts):
    """Line number of each token start within a byte buffer."""
    nl = np.flatnonzero(buf == 10)
    line_starts = np.concatenate(([0], nl + 1)).astype(np.int64)
    return (np.searchsorted(line_starts, starts, side="right")
            - 1).astype(np.int32)


def _numpy_counts_block(data, mode, lower, dedup_per_line,
                        pair_values=True):
    """Pure-numpy scanner (exact: grouping by token bytes, not hashes)."""
    from ..blocks import Block

    buf = np.frombuffer(data, dtype=np.uint8)
    if lower:
        buf = _LOWER[buf]
    starts, lens = _token_bounds(buf, mode)
    if len(starts) == 0:
        return Block.empty()
    line_id = line_ids(buf, starts) if dedup_per_line else None

    bb = buf.tobytes()
    keys, counts = [], []
    short = lens <= _SHORT_TOKEN
    long_idx = np.flatnonzero(~short)
    if len(long_idx):
        agg = {}
        seen = set()
        for i in long_idx:
            tok = bb[starts[i]:starts[i] + lens[i]].decode("utf-8", "replace")
            if dedup_per_line:
                key = (int(line_id[i]), tok)
                if key in seen:
                    continue
                seen.add(key)
            agg[tok] = agg.get(tok, 0) + 1
        keys.extend(agg.keys())
        counts.extend(agg.values())

    sidx = np.flatnonzero(short)
    if len(sidx):
        uniq, ucounts = group_token_rows(
            buf, starts[sidx], lens[sidx],
            line_id[sidx] if dedup_per_line else None, dedup_per_line)
        for i in range(len(uniq)):
            ln = int(uniq[i, 0])
            keys.append(uniq[i, 1:1 + ln].tobytes().decode("utf-8", "replace"))
            counts.append(int(ucounts[i]))

    return _block_of(keys, counts, pair_values)


def _block_of(keys, counts, pair_values, h1=None, h2=None):
    from ..blocks import Block

    ng = len(keys)
    kcol = np.empty(ng, dtype=object)
    for i in range(ng):
        kcol[i] = keys[i]
    if pair_values:
        vcol = np.empty(ng, dtype=object)
        for i in range(ng):
            vcol[i] = (keys[i], int(counts[i]))
    else:
        vcol = np.asarray(counts, dtype=np.int64)
    if h1 is None:
        h1, h2 = hashing.hash_keys(kcol)
    return Block(kcol, vcol, h1, h2)


# ASCII-only case fold for representative decoding (A-Z only), matching the
# byte semantics of the native hash pass.
_ASCII_LOWER = bytes.maketrans(bytes(range(65, 91)), bytes(range(97, 123)))


def _native_counts_block(data, mode, lower, dedup_per_line,
                         pair_values=True):
    """Fused native tokenize(+case-fold)+count -> Block, or None."""
    from .. import native

    buf = np.frombuffer(data, dtype=np.uint8)
    # the native codec's time is devtime's codec bucket
    with devtime.track("codec"):
        res = native.token_counts(buf, 1 if mode == "word" else 0,
                                  1 if lower else 0, dedup_per_line)
    if res is None:
        return None
    h1, h2, counts, rep_start, rep_len = res
    n = len(h1)
    keys = [None] * n
    lossy = []
    for i in range(n):
        s = rep_start[i]
        raw = bytes(data[s:s + rep_len[i]])
        if lower:
            raw = raw.translate(_ASCII_LOWER)
        tok = raw.decode("utf-8", "replace")
        keys[i] = tok
        if "�" in tok:
            lossy.append(i)
    blk = _block_of(keys, counts, pair_values, h1, h2)
    if lossy:
        # The native pass hashed the raw bytes, but a lossy decode
        # materialized a U+FFFD key: recompute those lanes from the key so
        # cached lanes always equal hash_keys(key).
        idx = np.asarray(lossy, dtype=np.int64)
        rh1, rh2 = hashing.hash_keys(blk.keys.take(idx))
        blk.h1 = np.array(h1, dtype=np.uint32, copy=True)
        blk.h2 = np.array(h2, dtype=np.uint32, copy=True)
        blk.h1[idx] = rh1
        blk.h2[idx] = rh2
    return blk


def _iter_aligned_windows(blocks):
    """Re-chop a byte-block stream at newlines with no large copies: each
    block yields a small straddle buffer (the carried partial line plus
    this block's head through its first newline) and its interior through
    its last newline as a memoryview.  No line spans two windows."""
    tail = []
    for b in blocks:
        mv = memoryview(b)
        start = 0
        if tail:
            nl = b.find(b"\n")
            if nl < 0:
                tail.append(b)
                continue
            tail.append(bytes(mv[:nl + 1]))
            yield b"".join(tail)
            tail = []
            start = nl + 1
        last = b.rfind(b"\n")
        if last < start:
            if start < len(b):
                tail.append(bytes(mv[start:]))
            continue
        yield mv[start:last + 1]
        if last + 1 < len(b):
            tail.append(bytes(mv[last + 1:]))
    if tail:
        yield b"".join(tail)


def _scan_windows(dataset):
    """Line-aligned byte windows of a chunk."""
    from .. import settings

    if hasattr(dataset, "iter_byte_blocks"):
        blocks = dataset.iter_byte_blocks(settings.scan_window_bytes)
    else:
        blocks = iter((dataset.read_bytes(),))
    return _iter_aligned_windows(blocks)


class _StatelessWindowSink(object):
    """Window sink for scanners with no cross-window state."""

    def __init__(self, fn):
        self._fn = fn

    def add(self, win):
        return self._fn(win)

    def finish(self):
        return ()


def _drive_windows(mapper, dataset, sink=None):
    """Run a window sink (the mapper's own, or the device sink the runner
    passes) over the chunk's line-aligned windows."""
    if sink is None:
        sink = mapper.window_sink()
    for win in _scan_windows(dataset):
        for blk in sink.add(win) or ():
            yield blk
    for blk in sink.finish() or ():
        yield blk


def chunk_token_counts(data, mode="whitespace", lower=False,
                       pair_values=True):
    """bytes -> Block of (token, count) with cached hash lanes."""
    blk = _native_counts_block(data, mode, lower, dedup_per_line=0,
                               pair_values=pair_values)
    if blk is not None:
        return blk
    return _numpy_counts_block(data, mode, lower, dedup_per_line=0,
                               pair_values=pair_values)


def chunk_doc_freq(data, mode="word", lower=True, pair_values=True):
    """bytes -> Block of (token, n_lines_containing)."""
    blk = _native_counts_block(data, mode, lower, dedup_per_line=1,
                               pair_values=pair_values)
    if blk is None:
        blk = _numpy_counts_block(data, mode, lower, dedup_per_line=1,
                                  pair_values=pair_values)
    if any(isinstance(k, str) and "�" in k for k in blk.keys):
        # A lossy decode breaks the per-line set contract (distinct
        # invalid byte tokens on one line all become the same U+FFFD
        # string): re-run on the round-trip-clean re-encoding.
        data = bytes(data)
        clean = data.decode("utf-8", "replace").encode("utf-8")
        if clean != data:
            blk = _native_counts_block(clean, mode, lower, dedup_per_line=1,
                                       pair_values=pair_values)
            if blk is None:
                blk = _numpy_counts_block(clean, mode, lower,
                                          dedup_per_line=1,
                                          pair_values=pair_values)
    return blk


def _per_record_counts(datasets, mode, lower, dedup, pair_values):
    """Exact per-record fallback for datasets without raw bytes."""
    import collections
    import re

    if len(datasets) != 1:
        raise ValueError("scanners map exactly one input")
    counts = collections.Counter()
    rx = re.compile(r"[^\w]+") if mode == "word" else None
    for _k, line in datasets[0].read():
        if lower:
            line = line.lower()
        toks = [t for t in (rx.split(line) if rx else line.split()) if t]
        counts.update(set(toks) if dedup else toks)
    if pair_values:
        return iter((t, (t, c)) for t, c in counts.items())
    return iter(counts.items())


class TokenCounts(Mapper):
    """Word count over raw text chunks: (token, count) records, folded per
    window.  ``pair_values=False`` emits plain int counts (pair with
    ``fold_values``)."""

    streams_bytes = True

    def __init__(self, mode="whitespace", lower=False, pair_values=True):
        self.mode = mode
        self.lower = lower
        self.pair_values = pair_values

    def window_sink(self):
        def scan(win):
            blk = chunk_token_counts(win, self.mode, self.lower,
                                     self.pair_values)
            return (blk,) if blk is not None and len(blk) else ()
        return _StatelessWindowSink(scan)

    def map_blocks(self, dataset):
        return _drive_windows(self, dataset)

    def map(self, *datasets):
        return _per_record_counts(datasets, self.mode, self.lower, False,
                                  self.pair_values)


class CountRecords(Mapper):
    """The ``len()`` map: one ``(1, count)`` record per chunk.  A text
    chunk's count is its owned newlines, plus one for an unterminated
    last line, counted over the same line-aligned windows the scanners
    read; a block-backed chunk sums its block lengths."""

    streams_bytes = True

    class _Sink(object):
        """Window sink whose newline count carries across windows (the
        aligned windows hold every byte of the chunk exactly once)."""

        def __init__(self):
            self.n = 0
            self.last = b"\n"

        def add(self, win):
            if isinstance(win, memoryview):
                # a numpy view counts without copying the window
                self.n += int(np.count_nonzero(
                    np.frombuffer(win, dtype=np.uint8) == 10))
            else:
                self.n += win.count(b"\n")
            if len(win):
                self.last = bytes(win[-1:])
            return ()

        def finish(self):
            from ..blocks import Block

            if self.last != b"\n":
                self.n += 1
            return (Block.from_pairs([(1, self.n)]),)

    def window_sink(self):
        return CountRecords._Sink()

    def map_blocks(self, dataset):
        return _drive_windows(self, dataset)

    def map(self, *datasets):
        ds = _one_input(datasets)
        if hasattr(ds, "iter_blocks"):
            yield 1, sum(len(b) for b in ds.iter_blocks())
        else:
            yield 1, sum(1 for _ in ds.read())


class DocFreq(Mapper):
    """Per-line token document frequency (the TF-IDF benchmark's map)."""

    streams_bytes = True

    def __init__(self, mode="word", lower=True, pair_values=True):
        self.mode = mode
        self.lower = lower
        self.pair_values = pair_values

    def window_sink(self):
        # Windows break at newlines, so per-line dedup never spans one.
        def scan(win):
            blk = chunk_doc_freq(win, self.mode, self.lower,
                                 self.pair_values)
            return (blk,) if blk is not None and len(blk) else ()
        return _StatelessWindowSink(scan)

    def map_blocks(self, dataset):
        return _drive_windows(self, dataset)

    def map(self, *datasets):
        return _per_record_counts(datasets, self.mode, self.lower, True,
                                  self.pair_values)


class ParseNumbers(Mapper):
    """Numeric-line parser: each line holds one number, and records come
    out keyed by the parsed value, so a bare ``checkpoint()`` after it
    reads back globally sorted (the external sort).  ``dtype`` is int64
    or float64."""

    streams_bytes = True

    def __init__(self, dtype=np.int64):
        self.dtype = np.dtype(dtype)

    def window_sink(self):
        from .. import native
        from ..blocks import Block

        # Windows break at newlines and each line holds one number, so no
        # value spans two windows.
        def scan(data):
            if self.dtype == np.int64:
                with devtime.track("codec"):
                    arr = native.parse_i64(np.frombuffer(data,
                                                         dtype=np.uint8))
                if arr is not None:
                    return (Block(arr, arr.copy()),) if len(arr) else ()
            # no native library, or float64: numpy parses each token in C
            # and raises on the first unparsable one
            toks = bytes(data).split()
            if not toks:
                return ()
            arr = np.array(toks, dtype=self.dtype)
            return (Block(arr, arr.copy()),)
        return _StatelessWindowSink(scan)

    def map_blocks(self, dataset):
        return _drive_windows(self, dataset)

    def map(self, *datasets):
        caster = int if self.dtype.kind == "i" else float
        for _k, line in _one_input(datasets).read():
            if line.strip():
                v = caster(line)
                yield v, v
