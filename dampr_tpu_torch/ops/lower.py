"""The lowered map->fold stage: one device program per token batch.

Port of ``dampr_tpu/ops/lower.py``.  A stage whose mapper is a
native-vocabulary scanner (``TokenCounts``/``DocFreq``) feeding a keyed
sum fold runs its windows through :func:`token_fold` instead of the host
codec:

- **host (feed)**: the case fold, then the window's tokens as compact
  lanes (:func:`scan_lanes`: int32 starts, uint8 lengths, int32 line ids,
  built a line-aligned slice at a time), and each batch's compact upload
  (the byte span its tokens cover, offsets into it, lengths, lines)
  staged in a small ring of reused (pinned, on a card) host buffers
  while the previous batch's program runs (double buffering);
- **device**: the row builder (:func:`.fnv.build_rows`) turning the
  upload into the padded token matrix, then :func:`token_fold` — the FNV
  kernel writing the sort keys
  (:mod:`.fnv`), a stable ``(inv, h1, h2[, line])`` sort, then the
  segmented-fold kernel (:mod:`.segfold`) in one pass: per-line
  first-occurrence dedup, segment totals, segment representatives and a
  byte-exact collision check;
- **host (drain)**: wait for the batch, decode the vocabulary-sized
  survivors' strings, build the partial-count Block the fold consumes.

Exactness: grouping is by the 64-bit dual hash, and the program verifies
every token's bytes equal its segment representative's; a collision
regroups that batch exactly on host.  Non-round-trip UTF-8 windows and
lines wider than a batch take the whole-window host path, and tokens over
``_SHORT_TOKEN`` bytes count on host.  Each of these adds to
``DeviceTokenFoldSink.fallbacks``.  Per-batch partials merge in the
downstream sum fold, so batch boundaries are unobservable in the results.

On a ``handoff="device"`` edge the sink keeps the counts on the device
instead (:mod:`.handoff`): the first batches' drains seed a per-job
vocabulary, later batches run its table program, and the job's end
registers the counts as device-resident refs for the fold.

Observability: each host phase of the sink (:data:`PHASES`) is timed at
one site (``DeviceTokenFoldSink._phase``), whose one clock reading feeds
every reader: the sink's ``seconds`` (and, while tracing or profiling,
its thread CPU in ``cpu_seconds``), devtime's bucket (the scan and the
padded batch, its staging, copy up and row build, are ``codec`` time,
the dispatch and the wait ``device`` time), one span on the thread that
runs the phase (``codec:sink-scan``,
``codec:sink-pad``, ``device:map-fold``, ``device:drain``,
``fold:sink-decode``, ``handoff:absorb``; a table batch's dispatch and
wait are ``handoff:table-probe`` and ``handoff:table-drain``), and the
per-operator profiler's ``build`` (the padded batch), ``h2d`` (copies
and kernels queued), ``compute`` (the host blocked on the card: the
batch's event, which covers its copies back) and ``d2h`` (the results
read and decoded).  No site adds a synchronisation: the drain's wait is
the sink's own.
"""


import contextlib

import numpy as np
import torch

from .. import faults as _faults
from .. import settings
from ..obs import profile as _profile
from ..obs import trace as _trace
from . import devtime
from . import fnv as _fnv
from . import segfold as _segfold
from .text import (_LOWER, _SHORT_TOKEN, _block_of, _token_bounds,
                   chunk_doc_freq, chunk_token_counts, group_token_rows,
                   line_ids)

# ---------------------------------------------------------------------------
# Stage claims
# ---------------------------------------------------------------------------


def claims(mapper):
    """Lowering params for a mapper the device program executes exactly,
    or None.  Exact types only: a subclass may have changed semantics."""
    from .text import DocFreq, TokenCounts

    if type(mapper) is TokenCounts:
        dedup = False
    elif type(mapper) is DocFreq:
        dedup = True
    else:
        return None
    if mapper.mode not in ("word", "whitespace"):
        return None
    return {"mode": mapper.mode, "lower": bool(mapper.lower),
            "dedup": dedup, "pair_values": bool(mapper.pair_values)}


# ---------------------------------------------------------------------------
# The device program
# ---------------------------------------------------------------------------


def _pow2(n):
    return max(8, 1 << max(0, (n - 1).bit_length()))


def _len_bucket(max_len):
    from .hashing import _len_bucket as hb

    return hb(max(1, int(max_len)))


def token_fold(mat, lens, lines, dedup, hash_fn=None, fold_fn=None):
    """Hash -> sort -> dedup -> segment totals -> collision check over a
    padded token matrix; the torch counterpart of the reference's
    ``_token_fold_jit`` with the same six outputs, position by position:

    ``(sh1, sh2, tot, live, rep_orig, collisions)`` — the sorted hash
    lanes (int32 bit patterns), segment totals at segment ends (int32),
    the live-end mask (bool), each position's segment representative as
    an original row index (int32), and the count of valid tokens whose
    bytes differ from their representative's (0-d int64).

    ``mat`` uint8 [n, L], ``lens`` int32 [n] (0 marks a pad row), ``lines``
    int32 [n] (< 2^31; read only when ``dedup``).  ``hash_fn``/``fold_fn``
    default to the kernels' fused entries (:func:`.fnv.fnv_sort_keys`,
    :func:`.segfold.segfold_gather`); the card check passes their plain
    versions instead."""
    hash_fn = hash_fn or _fnv.fnv_sort_keys
    fold_fn = fold_fn or _segfold.segfold_gather
    low, high = hash_fn(mat, lens, lines if dedup else None)
    perm, shigh = sort_segments(low, high)
    return fold_fn(perm, shigh, low, mat, lens, dedup)


def sort_segments(low, high):
    """The sort stage of :func:`token_fold`: the permutation that orders
    the rows by ``(high, low)``, ties by row — ``(inv, h1, h2[, line])``
    in unsigned lane order — and the high keys in that order.  torch has
    no multi-key sort: two stable passes, least significant key first."""
    _, p = torch.sort(low, stable=True)
    shigh, q = torch.sort(high[p], stable=True)
    return p[q], shigh


# ---------------------------------------------------------------------------
# The feed: compact token lanes and their staging
# ---------------------------------------------------------------------------

#: Bytes of a window the scan takes at a time (each slice ends at a
#: newline, so no token or line straddles two): no temporary of the scan
#: is wider than one slice.
SCAN_SLICE = 1 << 20


def _line_end(buf, at):
    """The index just past the first newline at or after ``at`` (the
    buffer's length when there is none)."""
    n = len(buf)
    step = 4096
    while at < n:
        hit = np.flatnonzero(buf[at:at + step] == 10)
        if len(hit):
            return at + int(hit[0]) + 1
        at += step
        step *= 2
    return n


def scan_slices(buf, size=SCAN_SLICE):
    """The window's ``[a, b)`` slices: about ``size`` bytes each, every one
    but the last ending just past a newline."""
    cuts = []
    a, n = 0, len(buf)
    while a < n:
        b = n if a + size >= n else _line_end(buf, a + size - 1)
        cuts.append((a, b))
        a = b
    return cuts


def scan_lanes(buf, mode, dedup, cuts):
    """A window's tokens as compact lanes, scanned slice by slice
    (``cuts``, :func:`scan_slices`) with ``text._token_bounds`` and
    ``text.line_ids``: its tokens, in its order.

    Returns ``(starts, lens, lines, long)``: the tokens of at most
    ``_SHORT_TOKEN`` bytes as window-relative int32 starts, uint8 lengths
    and, under ``dedup``, int32 line ids (else None); ``long`` the longer
    tokens' ``(starts, lens, lines)`` (int32 lengths), or None when there
    are none.  The window is under 2 GiB."""
    parts = ([], [], [])
    longs = ([], [], [])
    base_line = 0
    for a, b in cuts:
        s = buf[a:b]
        st, ln = _token_bounds(s, mode)
        li = None
        if dedup:
            li = line_ids(s, st)
            li += base_line
            base_line += int(np.count_nonzero(s == 10))
        st = st.astype(np.int32)
        st += a
        short = ln <= _SHORT_TOKEN
        if not short.all():
            big = ~short
            longs[0].append(st[big])
            longs[1].append(ln[big])
            longs[2].append(li[big] if dedup else None)
            st, ln = st[short], ln[short]
            li = li[short] if dedup else None
        parts[0].append(st)
        parts[1].append(ln.astype(np.uint8))
        if dedup:
            parts[2].append(li)

    def joined(pieces, dtype):
        # one lane at a time, its pieces dropped as it is joined
        out = (np.concatenate(pieces) if pieces
               else np.empty(0, dtype=dtype))
        del pieces[:]
        return out

    starts = joined(parts[0], np.int32)
    lens = joined(parts[1], np.uint8)
    lines = joined(parts[2], np.int32) if dedup else None
    long = None
    if longs[0]:
        long = (np.concatenate(longs[0]), np.concatenate(longs[1]),
                np.concatenate(longs[2]) if dedup else None)
    return starts, lens, lines, long


#: Slots of a sink's staging ring: the double-buffered feed has at most
#: two batches out, one in flight and one being staged.
RING_SLOTS = 2

#: Alignment (bytes) of each lane carved out of a staging buffer.
_ALIGN = 16


def _layout(specs):
    """``(offsets, total)`` of ``specs`` (``(dtype, numel)`` pairs, ``()``
    for a 0-d tensor) laid out one after another, each aligned."""
    offsets, at = [], 0
    for dtype, numel in specs:
        at = -(-at // _ALIGN) * _ALIGN
        offsets.append(at)
        at += (1 if numel == () else numel) * dtype.itemsize
    return offsets, at


def _views(buf, specs, offsets):
    """Typed views of a uint8 tensor at ``offsets`` (:func:`_layout`)."""
    out = []
    for (dtype, numel), at in zip(specs, offsets):
        k = 1 if numel == () else numel
        t = buf[at:at + k * dtype.itemsize].view(dtype)
        out.append(t.reshape(()) if numel == () else t)
    return out


class _StagingRing(object):
    """A sink's few reused host buffers (pinned on a card): each batch
    stages its compact upload in the next slot, and its results come back
    into the same slot.  On the card both are queued on one stream, the
    copy up before the copy back, so the results may overlay the upload.
    A slot is taken again only after the event recorded behind its last
    batch has completed.  A slot's buffer is made, or grows, only when a
    batch outgrows it, and then to the power of two that holds the most
    any use of the ring has asked for (an upload, or the results that
    come back over it), so the slots settle at one size; ``allocs``
    counts the buffers made."""

    def __init__(self, pinned, slots=RING_SLOTS):
        self.pinned = pinned
        self.bufs = [None] * slots
        self.events = [None] * slots
        self.slot = slots - 1
        self.high = 0
        self.allocs = 0

    def _fit(self, nbytes):
        buf = self.bufs[self.slot]
        if buf is None or buf.numel() < nbytes:
            self.high = max(self.high, nbytes)
            buf = torch.empty(_pow2(self.high), dtype=torch.uint8,
                              pin_memory=self.pinned)
            self.bufs[self.slot] = buf
            self.allocs += 1
        return buf

    def take(self, nbytes):
        """The next slot's buffer, at least ``nbytes``, once the work
        behind its last use is done."""
        self.slot = (self.slot + 1) % len(self.bufs)
        event = self.events[self.slot]
        if event is not None:
            event.synchronize()
            self.events[self.slot] = None
        return self._fit(nbytes)

    def views(self, specs):
        """Typed views of the current slot laid out from its start (a
        batch's results, over its upload), the slot grown to hold them;
        the old buffer, if any, stays alive while a copy reads it
        (torch's pinned allocator records the copy's event)."""
        offsets, nbytes = _layout(specs)
        return _views(self._fit(nbytes), specs, offsets)

    def done(self, event):
        """The event behind the current slot's batch (None: nothing
        queued)."""
        self.events[self.slot] = event


# ---------------------------------------------------------------------------
# The window sink
# ---------------------------------------------------------------------------


class _Batch(object):
    """One dispatched program plus what its drain needs.  ``out`` holds
    the host-side results (on a card, views of the sink's staging ring),
    filled once ``event`` completes; ``keep`` holds the device tensors
    until then."""

    __slots__ = ("out", "event", "keep", "starts", "lens", "n")

    def __init__(self, out, event, keep, starts, lens):
        self.out = out
        self.event = event
        self.keep = keep
        self.starts = starts
        self.lens = lens
        self.n = len(starts)


def _batch_bounds(lines, n_tokens, limit):
    """Batch cut points (token indices) on line boundaries, so per-line
    dedup never straddles a batch; None when one line exceeds the limit."""
    if n_tokens <= limit:
        return [(0, n_tokens)]
    cuts = [0]
    at = 0
    while at < n_tokens:
        end = min(at + limit, n_tokens)
        if end < n_tokens and lines is not None:
            line_at_end = lines[end]
            while end > at and lines[end - 1] == line_at_end:
                end -= 1
            if end == at:
                return None  # one line wider than a whole batch
        cuts.append(end)
        at = end
    return list(zip(cuts[:-1], cuts[1:]))


#: The host phases a DeviceTokenFoldSink times (see its ``seconds``).
PHASES = ("scan", "pad", "enqueue", "wait", "decode", "absorb")

#: Each phase's span (category, name), devtime bucket and per-operator
#: profiler label (None: none).
_PHASE_SITES = {
    "scan": ("codec", "sink-scan", "codec", None),
    "pad": ("codec", "sink-pad", "codec", "build"),
    "enqueue": ("device", "map-fold", "device", "h2d"),
    "wait": ("device", "drain", "device", "compute"),
    "decode": ("fold", "sink-decode", None, "d2h"),
    "absorb": ("handoff", "absorb", None, None),
}


class _SinkPhase(devtime.Timed):
    """One phase of a sink, timed at this one site: the reading feeds the
    sink's ``seconds`` and ``cpu_seconds``, devtime, the span and the
    profiler's label (``nbytes`` its bytes)."""

    __slots__ = ("sink", "phase", "label", "nbytes")

    def __init__(self, sink, phase, span, nbytes, args):
        cat, name, kind, self.label = _PHASE_SITES[phase]
        if span is not None:
            cat, name = span
        devtime.Timed.__init__(self, kind, cat, name, **args)
        self.sink = sink
        self.phase = phase
        self.nbytes = nbytes

    def __exit__(self, exc_type, exc, tb):
        devtime.Timed.__exit__(self, exc_type, exc, tb)
        self.sink.seconds[self.phase] += self.seconds
        if self.cpu is not None:
            self.sink.cpu_seconds[self.phase] += self.cpu
        if self.label is not None:
            _profile.device_add(self.label, self.seconds, self.nbytes)
        return False


class DeviceTokenFoldSink(object):
    """Window sink running the lowered program (drop-in for a scanner's
    ``window_sink()``): ``add(win)`` feeds the window through
    double-buffered dispatches and returns partial-count Blocks.

    On a card each sink owns a CUDA stream: a batch's compact upload, the
    row builder, the program and the device-to-host copy queue on it and
    the host moves on to stage the next batch; the drain waits on that
    batch's event only.  The staging and the results go through the
    sink's ring of reused host buffers (``staging_allocs`` counts the
    buffers it made); ``card_rows_batches`` counts the batches whose
    padded rows the row builder made from their compact upload on the
    program's device.

    ``handoff=True`` (the plan's ``handoff="device"`` edge,
    :mod:`.handoff`): the counts stay on the device in a per-job
    vocabulary instead of draining to host blocks.  Classic batches
    bootstrap the vocabulary, later batches run the table program, and
    :meth:`finalize_handoff` registers the counts as device-resident refs
    the fold reads in place.  A degrade flushes the accumulator into one
    hash-sorted block and the sink goes on emitting blocks, with identical
    results.  ``jobs`` (the stage's concurrent jobs) divides the run's
    handoff budget between the jobs' vocabularies."""

    def __init__(self, params, store=None, device=None, handoff=False,
                 jobs=1):
        self.mode = params["mode"]
        self.lower = params["lower"]
        self.dedup = params["dedup"]
        self.pair_values = params["pair_values"]
        self.store = store
        self.device = device if device is not None else \
            settings.resolve_device()
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            # The current device is per thread and the overlap executor's
            # producer thread drives the sink: pin the index here.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        self.batches = 0
        self.fallbacks = 0
        self.card_rows_batches = 0
        self._ring = _StagingRing(pinned=self._cuda)
        self._staged = 0  # the last batch's upload bytes
        #: classic batches dispatched while the handoff was live, and the
        #: windows that seeded the vocabulary through the host codec
        self.classic_batches = 0
        self.host_bootstraps = 0
        #: host seconds per phase of the lowered scan: ``scan`` (case fold,
        #: the compact token lanes), ``pad`` (the batch's compact upload
        #: staged and queued, and its rows built on the device),
        #: ``enqueue`` (queueing the program + copies back), ``wait``
        #: (blocked on a batch's
        #: results), ``decode`` (survivor strings -> Block) and ``absorb``
        #: (the handoff's host work: survivors and a table batch's misses
        #: into the vocabulary, a host bootstrap)
        self.seconds = dict.fromkeys(PHASES, 0.0)
        #: the thread CPU seconds of each phase, read while tracing or
        #: profiling (0 otherwise): ``seconds`` less them is waiting
        self.cpu_seconds = dict.fromkeys(PHASES, 0.0)
        self._hv = None
        if handoff and store is not None and not self.pair_values:
            from . import handoff as _handoff

            share = settings.effective_handoff_budget() // max(1, int(jobs))
            self._hv = _handoff.HandoffVocab(store, self.dedup, budget=share,
                                             device=self.device,
                                             stream=self._stream)

    @property
    def staging_allocs(self):
        """Host buffers the staging ring allocated: one a slot, and one
        more each time a batch's upload or results outgrow every size the
        ring has held (on a card the first results do, once)."""
        return self._ring.allocs

    @property
    def table_batches(self):
        return self._hv.table_batches if self._hv is not None else 0

    @property
    def misses(self):
        """Tokens of table batches that missed the vocabulary."""
        return self._hv.misses if self._hv is not None else 0

    # -- host fallbacks ----------------------------------------------------
    def _host_window(self, win):
        """Exact host path for one whole window."""
        self.fallbacks += 1
        scan = chunk_doc_freq if self.dedup else chunk_token_counts
        blk = scan(win, self.mode, self.lower, self.pair_values)
        return (blk,) if blk is not None and len(blk) else ()

    def _host_batch(self, buf, starts, lens, lines):
        """Exact host grouping of one collided batch (and of a table
        batch's misses once the vocabulary is gone)."""
        from . import hashing

        self.fallbacks += 1
        uniq, counts = group_token_rows(buf, starts, lens, lines,
                                        self.dedup)
        keys = np.empty(len(uniq), dtype=object)
        for i in range(len(uniq)):
            ln = int(uniq[i, 0])
            keys[i] = uniq[i, 1:1 + ln].tobytes().decode("utf-8", "replace")
        h1, h2 = hashing.hash_keys(keys)
        return self._emit(keys, counts.astype(np.int64), h1, h2)

    def _emit(self, keys, counts, h1, h2):
        return _block_of(keys, counts, self.pair_values, h1, h2)

    def _long_tokens(self, buf, starts, lens, lines):
        """Tokens over _SHORT_TOKEN bytes (their lanes), counted in a host
        dict."""
        from . import hashing

        agg = {}
        seen = set()
        for i in range(len(starts)):
            s = int(starts[i])
            tok = buf[s:s + int(lens[i])].tobytes().decode("utf-8",
                                                           "replace")
            if self.dedup:
                key = (int(lines[i]), tok)
                if key in seen:
                    continue
                seen.add(key)
            agg[tok] = agg.get(tok, 0) + 1
        keys = np.empty(len(agg), dtype=object)
        counts = np.empty(len(agg), dtype=np.int64)
        for i, (k, c) in enumerate(agg.items()):
            keys[i] = k
            counts[i] = c
        h1, h2 = hashing.hash_keys(keys)
        return self._emit(keys, counts, h1, h2)

    # -- the handoff ---------------------------------------------------------
    @property
    def _handoff_live(self):
        return self._hv is not None and not self._hv.degraded

    def _absorb_or_out(self, blocks, out):
        """Host-path blocks go into the vocabulary while the handoff is
        live (a refused absorb degrades: the flushed accumulator and the
        block both land in ``out``), else straight into ``out``."""
        for blk in blocks:
            if blk is None or not len(blk):
                continue
            if self._handoff_live:
                if self._hv.absorb_block(blk):
                    continue
                self._degrade_to(out, "vocabulary or lane budget exceeded")
            out.append(blk)

    def _degrade_to(self, out, reason):
        fb = self._hv.degrade(reason)
        if fb is not None and len(fb):
            out.append(fb)

    def _emit_table_misses(self, buf, batch, out, count_d2h):
        """A table batch's missed tokens once the vocabulary can no longer
        take them: grouped exactly on the host (as a collided batch is) and
        emitted.  ``count_d2h`` charges the miss lane's fetch where
        :meth:`.handoff.HandoffVocab.drain` has not."""
        n_miss = int(batch.n_miss)
        if count_d2h and self.store is not None:
            self.store.count_d2h(batch.npad + 4)
        if not n_miss:
            return
        if batch.miss_idx is None:
            batch.miss_idx = np.flatnonzero(batch.miss.numpy()[:batch.n])
        idx = batch.miss_idx
        blk = self._host_batch(
            buf, batch.starts[idx], batch.lens[idx],
            batch.lines[idx] if batch.lines is not None else None)
        if blk is not None and len(blk):
            out.append(blk)

    # -- the device path ---------------------------------------------------
    def _phase(self, phase, span=None, nbytes=0, **args):
        """The timing site of one ``phase`` (:data:`PHASES`); ``span``
        replaces its (category, name), ``args`` go on the span."""
        return _SinkPhase(self, phase, span, nbytes, args)

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _pad_batch(self, buf, starts, lens, lines):
        """The program's padded inputs on its device, from the batch's
        compact upload (:meth:`_pad_rows`); the upload's bytes are the
        batch's copy up."""
        with self._phase("pad") as ph:
            rows = self._pad_rows(buf, starts, lens, lines)
            ph.nbytes = self._staged
        if self.store is not None:
            self.store.count_h2d(self._staged)
        return rows

    def _pad_rows(self, buf, starts, lens, lines):
        """``(mat uint8 [npad, L], lens int32 [npad], lines int32 [npad])``
        on the program's device, rows padded to a power of two with lens 0
        (hence invalid): the byte span the batch's tokens cover, their
        offsets into it, their lengths and their lines (under dedup) are
        staged in the ring's next slot, copied up at once, and the row
        builder (:func:`.fnv.build_rows`) makes the rows there."""
        n = len(starts)
        L = _len_bucket(lens.max())
        npad = _pow2(n)
        s0 = int(starts[0])
        s1 = int(starts[-1]) + int(lens[-1])
        specs = [(torch.int32, n), (torch.uint8, n), (torch.uint8, s1 - s0)]
        if lines is not None:
            specs.append((torch.int32, n))
        offsets, nbytes = _layout(specs)
        host = self._ring.take(nbytes)
        staged = _views(host, specs, offsets)
        np.subtract(starts, s0, out=staged[0].numpy(), casting="unsafe")
        staged[1].numpy()[:] = lens
        staged[2].numpy()[:] = buf[s0:s1]
        if lines is not None:
            staged[3].numpy()[:] = lines
        self._staged = nbytes
        with self._on_stream():
            up = _views(host[:nbytes].to(self.device, non_blocking=True),
                        specs, offsets)
            rows = _fnv.build_rows(up[2], up[0], up[1],
                                   up[3] if lines is not None else None,
                                   npad, L)
        self.card_rows_batches += 1
        return rows

    def _dispatch(self, rows, starts, lens):
        """Queue one classic batch over its padded rows: the program,
        results down."""
        with self._phase("enqueue", nbytes=self._staged, tokens=len(starts),
                         bytes=self._staged):
            batch = self._enqueue(rows, starts, lens)
        self.batches += 1
        return batch

    def _enqueue(self, rows, starts, lens):
        event = keep = None
        if self._cuda:
            with self._on_stream():
                res = token_fold(*rows, self.dedup)
                out = self._ring.views([(r.dtype, r.numel() if r.dim() else ())
                                        for r in res])
                for h, r in zip(out, res):
                    h.copy_(r, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._stream)
            keep = (rows, res)
        else:
            out = token_fold(*rows, self.dedup)
        self._ring.done(event)
        return _Batch(out, event, keep, starts, lens)

    def _next_batch(self, buf, starts, lens, lines, out):
        """Dispatch one batch through the program the vocabulary calls for:
        the table program once it has converged, the classic one
        otherwise.  A refused table dispatch (the count guard, the budget)
        degrades the job, and the batch's rows go classic.  Each
        program's dispatch is a ``device_dispatch`` fault site: a failure
        there surfaces through the map job and rides the job retry loop
        (a table fault fails the job, it never degrades it)."""
        table = self._handoff_live and self._hv.table_mode
        _faults.check("device_dispatch")
        rows = self._pad_batch(buf, starts, lens, lines)
        if table:
            with self._phase(
                    "enqueue", ("handoff", "table-probe"),
                    nbytes=self._staged, tokens=len(starts),
                    bytes=self._staged):
                batch = self._hv.dispatch(rows, starts, lens, lines,
                                          len(starts), self._ring)
            if batch is not None:
                self.batches += 1
                return batch
            self._degrade_to(out, "count-lane overflow guard or hbm budget "
                                  "exceeded mid-stage")
            _faults.check("device_dispatch")
        if self._handoff_live:
            self.classic_batches += 1
        return self._dispatch(rows, starts, lens)

    def _wait(self, batch, span=None):
        """Block until one dispatch's results are on the host (a table
        batch's wait is a ``handoff`` span, as its dispatch is)."""
        with self._phase("wait", span, tokens=len(batch.starts)):
            if batch.event is not None:
                batch.event.synchronize()
        batch.keep = None

    def _resolve(self, buf, batch, out):
        """Drain one dispatch of either program into ``out`` (or into the
        vocabulary while the handoff is live)."""
        from .handoff import _TABLE_REVERT_MISS_FRAC, _TableBatch

        if not isinstance(batch, _TableBatch):
            blk = self._drain(buf, batch, out)
            if blk is not None and len(blk):
                out.append(blk)
            return
        self._wait(batch, ("handoff", "table-drain"))
        if not self._handoff_live:
            # The vocabulary degraded while this batch was in flight: its
            # hits left with the flush (they counted at dispatch), but its
            # misses landed nowhere.
            with self._phase("decode"):
                self._emit_table_misses(buf, batch, out, count_d2h=True)
            return
        with self._phase("absorb"):
            ok, miss_frac = self._hv.drain(buf, batch)
            if not ok:
                # the refused absorb landed no miss count: the flush holds
                # this batch's hits only, its misses go out on the host
                self._degrade_to(out, "vocabulary or lane budget exceeded")
                self._emit_table_misses(buf, batch, out, count_d2h=False)
            elif miss_frac > _TABLE_REVERT_MISS_FRAC:
                # the vocabulary shifted: bootstrap again
                self._hv.table_mode = False

    def _drain(self, buf, batch, out=None):
        """Wait for one classic batch and build its partial-count Block (a
        collision regroups the batch on host).  While the handoff is live
        the survivors seed the vocabulary instead (returns None)."""
        from .handoff import _TABLE_ENTER_NEW_FRAC

        self._wait(batch)
        with self._phase("decode") as ph:
            sh1, sh2, tot, live, rep_orig, collisions = (
                t.numpy() for t in batch.out)
            ph.nbytes = sum(t.numel() * t.element_size() for t in batch.out)
            if self.store is not None:
                self.store.count_d2h(ph.nbytes)
            if int(collisions):
                lines = line_ids(buf, batch.starts) if self.dedup else None
                blk = self._host_batch(buf, batch.starts, batch.lens, lines)
                if self._handoff_live and out is not None:
                    self._absorb_or_out((blk,), out)
                    return None
                return blk
            idx = np.flatnonzero(live)
            if not len(idx):
                return None
            counts = tot[idx].astype(np.int64)
            reps = rep_orig[idx]
            keys = np.empty(len(idx), dtype=object)
            starts, lens = batch.starts, batch.lens
            for i, r in enumerate(reps):
                s = int(starts[r])
                keys[i] = buf[s:s + int(lens[r])].tobytes().decode(
                    "utf-8", "replace")
            h1g, h2g = sh1[idx].view(np.uint32), sh2[idx].view(np.uint32)
            if not self._handoff_live:
                return self._emit(keys, counts, h1g, h2g)
        blk = None
        with self._phase("absorb"):
            ok, new_frac = self._hv.absorb_drain(keys, counts, h1g, h2g,
                                                 batch.n)
            if ok:
                if new_frac < _TABLE_ENTER_NEW_FRAC:
                    self._hv.table_mode = True
            else:
                blk = self._emit(keys, counts, h1g, h2g)
                if out is not None:
                    self._degrade_to(out, "vocabulary or lane budget "
                                          "exceeded")
                    out.append(blk)
                    blk = None
        return blk

    def _bootstrap_on_host(self, data, out):
        """Seed an empty vocabulary from one whole window through the host
        codec (the CPU's bootstrap, :func:`.handoff._host_bootstrap`), and
        take the table program from the next window on; a vocabulary that
        does not cover it reverts through the miss bar."""
        from .handoff import CLASSIC_DRAIN_BYTES_PER_SLOT

        # the bootstrap stands in for this window's dispatches, so it
        # keeps their fault site
        _faults.check("device_dispatch")
        scan = chunk_doc_freq if self.dedup else chunk_token_counts
        with self._phase("absorb"):
            with _trace.span("handoff", "bootstrap-host", bytes=len(data)):
                # the host grouping is codec work: traced and bucketed as
                # such
                with devtime.track("codec"), _trace.span(
                        "codec", "codec-window", bytes=len(data)):
                    blk = scan(data, self.mode, self.lower,
                               self.pair_values)
                self.host_bootstraps += 1
                self._absorb_or_out((blk,) if blk is not None else (), out)
            if self._handoff_live and self._hv.nslots:
                self._hv.table_mode = True
                if self.store is not None and blk is not None:
                    # the drain the classic path would have fetched for
                    # this window, one batch's lower bound
                    self.store.count_d2h_avoided(
                        CLASSIC_DRAIN_BYTES_PER_SLOT * len(blk))
        return out

    def add(self, win):
        from . import handoff as _handoff

        buf = np.frombuffer(win, dtype=np.uint8)
        if not len(buf):
            return ()
        out = []
        if len(buf) >= 1 << 31:
            # past the int32 lanes (a line longer than the scan window)
            self._absorb_or_out(self._host_window(win), out)
            return out
        cuts = scan_slices(buf)
        if buf.max() > 127:
            # Only valid-UTF-8 windows lower: token substrings of valid
            # UTF-8 decode losslessly, so keys can never desync from their
            # byte hash lanes or the per-line byte dedup.  A slice ends at
            # a newline, which no multibyte sequence holds, so the slices
            # decode as the window does.
            mv = memoryview(win)
            try:
                for a, b in cuts:
                    str(mv[a:b], "utf-8")
            except UnicodeDecodeError:
                self._absorb_or_out(self._host_window(win), out)
                return out
        if (self._handoff_live and not self._hv.table_mode
                and not self._hv.nslots and _handoff._host_bootstrap()):
            return self._bootstrap_on_host(win, out)
        with self._phase("scan"):
            if self.lower:
                buf = _LOWER[buf]
            s_starts, s_lens, s_lines, long = scan_lanes(
                buf, self.mode, self.dedup, cuts)
        ns = len(s_starts)
        if ns == 0 and long is None:
            return ()

        bounds = (_batch_bounds(s_lines, ns, max(1024, settings.lower_batch))
                  if ns else [])
        if bounds is None:
            # The whole-window host path recounts every token, long ones
            # included, so nothing else may land for this window.
            self._absorb_or_out(self._host_window(win), out)
            return out
        if long is not None:
            self._absorb_or_out((self._long_tokens(buf, *long),), out)

        # Double-buffered feed: dispatch batch i+1 before draining batch i.
        pending = None
        try:
            for a, b in bounds:
                if (pending is not None and self._handoff_live
                        and not self._hv.table_mode
                        and not self._hv.nslots):
                    # The job's first classic batch resolves before the
                    # next dispatch: its drain seeds the vocabulary, so the
                    # rest of the job can take the table program.
                    self._resolve(buf, pending, out)
                    pending = None
                nxt = self._next_batch(
                    buf, s_starts[a:b], s_lens[a:b],
                    s_lines[a:b] if s_lines is not None else None, out)
                if pending is not None:
                    self._resolve(buf, pending, out)
                pending = nxt
            if pending is not None:
                self._resolve(buf, pending, out)
        except BaseException:
            # a batch still in flight reads or writes the ring's host
            # buffers: it lands before anything takes them again
            self._wait_inflight()
            raise
        return [blk for blk in out if blk is not None and len(blk)]

    def _wait_inflight(self):
        """Block until every copy and kernel this sink queued on its stream
        (classic and table batches, the vocabulary's uploads) is done."""
        if self._stream is not None:
            self._stream.synchronize()

    def abort(self):
        """A failed job attempt's end: wait out the work in flight, then
        drop the vocabulary and its device accumulator (a retried attempt
        builds a fresh sink; nothing of this one is ever registered)."""
        self._wait_inflight()
        if self._hv is not None:
            self._hv._reset()

    def finish(self):
        return ()

    def finalize_handoff(self, store, n_partitions):
        """Register the job's vocabulary as per-partition device refs (the
        ``handoff="device"`` edge).  Returns ``(blocks, {pid: [BlockRef]})``
        with at most one side non-empty: ``blocks`` is a degrade flush the
        caller pushes through the classic combine."""
        if self._hv is None:
            return (), {}
        return self._hv.finalize(store, n_partitions)


def device_window_sink(mapper, store=None, handoff=False, jobs=1):
    """The device window sink for a claimed mapper, or None.
    ``handoff=True`` arms the device-resident handoff (a pair-values
    scanner, an object lane with no device tier, stays on the classic
    path); ``jobs`` is the stage's concurrent job count."""
    params = claims(mapper)
    if params is None:
        return None
    return DeviceTokenFoldSink(params, store=store, handoff=handoff,
                               jobs=jobs)
