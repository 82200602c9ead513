"""The lowered map->fold stage: one device program per token batch.

Port of ``dampr_tpu/ops/lower.py``.  A stage whose mapper is a
native-vocabulary scanner (``TokenCounts``/``DocFreq``) feeding a keyed
sum fold runs its windows through :func:`token_fold` instead of the host
codec:

- **host (feed)**: token bounds and case fold from the byte tables
  (:mod:`.text`), per-line ids, and the padded token byte matrix, written
  straight into pinned buffers for the next batch while the previous
  batch's program runs (double buffering);
- **device**: :func:`token_fold` — the FNV kernel writing the sort keys
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

Observability, at the JAX package's sites: the scan and the padded
batch are ``codec`` time (devtime), each dispatch is a ``device`` span
(``map-fold``) and ``device`` time, each wait for a batch's results a
``device`` span (``drain``; a table batch's dispatch and wait are
``handoff`` spans, :mod:`.handoff`).  Under the per-operator profiler
the host seconds split into ``build`` (the padded batch), ``h2d``
(copies and kernels queued), ``compute`` (the host blocked on the card:
the batch's event, which covers its copies back) and ``d2h`` (the
results read and decoded).  No site adds a synchronisation: the drain's
wait is the sink's own.
"""

import time

import numpy as np
import torch

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
# The window sink
# ---------------------------------------------------------------------------


class _Batch(object):
    """One dispatched program plus what its drain needs.  ``out`` holds
    the host-side (pinned, on a card) result buffers, filled once
    ``event`` completes (``start`` marks when the batch's stream work
    began); ``keep`` pins the inputs until then."""

    __slots__ = ("out", "start", "event", "keep", "starts", "lens", "n")

    def __init__(self, out, start, event, keep, starts, lens):
        self.out = out
        self.start = start
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


class DeviceTokenFoldSink(object):
    """Window sink running the lowered program (drop-in for a scanner's
    ``window_sink()``): ``add(win)`` feeds the window through
    double-buffered dispatches and returns partial-count Blocks.

    On a card each sink owns a CUDA stream: a batch's host-to-device copy,
    program and device-to-host copy queue on it and the host moves on to
    build the next batch; the drain waits on that batch's event only.

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
        #: classic batches dispatched while the handoff was live, and the
        #: windows that seeded the vocabulary through the host codec
        self.classic_batches = 0
        self.host_bootstraps = 0
        #: host seconds per phase of the lowered scan: ``scan`` (case fold,
        #: token bounds, line ids), ``pad`` (the padded batch), ``enqueue``
        #: (queueing copies + program), ``wait`` (blocked on a batch's
        #: results), ``decode`` (survivor strings -> Block) and ``absorb``
        #: (the handoff's host work: survivors and a table batch's misses
        #: into the vocabulary, a host bootstrap)
        self.seconds = dict.fromkeys(PHASES, 0.0)
        #: summed per-batch span on the card's stream (copies + program),
        #: from CUDA events; 0 on the CPU
        self.stream_seconds = 0.0
        self._hv = None
        if handoff and store is not None and not self.pair_values:
            from . import handoff as _handoff

            share = settings.effective_handoff_budget() // max(1, int(jobs))
            self._hv = _handoff.HandoffVocab(store, self.dedup, budget=share,
                                             device=self.device,
                                             stream=self._stream)

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

    def _long_tokens(self, buf, starts, lens, line_id, long_idx):
        """Tokens over _SHORT_TOKEN bytes, counted in a host dict."""
        from . import hashing

        bb = buf.tobytes()
        agg = {}
        seen = set()
        for i in long_idx:
            s = int(starts[i])
            tok = bb[s:s + int(lens[i])].decode("utf-8", "replace")
            if self.dedup:
                key = (int(line_id[i]), tok)
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
    def _host_buffer(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=self._cuda)

    def _pad_batch(self, buf, starts, lens, lines):
        """The padded program inputs, built in place in (pinned) host
        tensors: rows pad to a power of two with lens 0 (hence invalid)."""
        prof = _profile.active()
        t0 = time.perf_counter()
        with devtime.track("codec"):
            out = self._pad_rows(buf, starts, lens, lines)
        if prof is not None:
            prof.device_add("build", time.perf_counter() - t0,
                            out[0].numel())
        return out

    def _pad_rows(self, buf, starts, lens, lines):
        n = len(starts)
        L = _len_bucket(lens.max())
        npad = _pow2(n)
        mat_t = self._host_buffer((npad, L), torch.uint8)
        lens_t = self._host_buffer((npad,), torch.int32)
        lines_t = self._host_buffer((npad,), torch.int32)
        mat, lens_p, lines_p = mat_t.numpy(), lens_t.numpy(), lines_t.numpy()
        idx = starts[:, None] + np.arange(L, dtype=np.int64)[None, :]
        np.clip(idx, 0, len(buf) - 1, out=idx)
        mat[:n] = np.where(np.arange(L, dtype=np.int32)[None, :]
                           < lens[:, None], buf[idx], 0)
        mat[n:] = 0
        lens_p[:n] = lens
        lens_p[n:] = 0
        lines_p[:] = 0
        if lines is not None:
            lines_p[:n] = lines
        return mat_t, lens_t, lines_t

    def _dispatch(self, buf, starts, lens, lines):
        """Queue one classic batch: inputs up, the program, results down."""
        t0 = time.perf_counter()
        inputs = self._pad_batch(buf, starts, lens, lines)
        nbytes = sum(t.numel() * t.element_size() for t in inputs)
        if self.store is not None:
            self.store.count_h2d(nbytes)
        t1 = time.perf_counter()
        self.seconds["pad"] += t1 - t0
        with devtime.track("device"), _trace.span(
                "device", "map-fold", tokens=len(starts), bytes=nbytes):
            batch = self._enqueue(inputs, starts, lens)
        t2 = time.perf_counter()
        self.seconds["enqueue"] += t2 - t1
        prof = _profile.active()
        if prof is not None:
            prof.device_add("h2d", t2 - t1, nbytes)
        self.batches += 1
        return batch

    def _enqueue(self, inputs, starts, lens):
        start = None
        if self._cuda:
            with torch.cuda.stream(self._stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record(self._stream)
                mat, lens_d, lines_d = (t.to(self.device, non_blocking=True)
                                        for t in inputs)
                res = token_fold(mat, lens_d, lines_d, self.dedup)
                out = []
                for r in res:
                    h = self._host_buffer(r.shape, r.dtype)
                    h.copy_(r, non_blocking=True)
                    out.append(h)
                event = torch.cuda.Event(enable_timing=True)
                event.record(self._stream)
            keep = (inputs, mat, lens_d, lines_d, res)
        else:
            out = token_fold(*inputs, self.dedup)
            event, keep = None, None
        return _Batch(out, start, event, keep, starts, lens)

    def _next_batch(self, buf, starts, lens, lines, out):
        """Dispatch one batch through the program the vocabulary calls for:
        the table program once it has converged, the classic one
        otherwise.  A refused table dispatch (the count guard, the budget)
        degrades the job, and the batch goes classic."""
        if self._handoff_live and self._hv.table_mode:
            t0 = time.perf_counter()
            inputs = self._pad_batch(buf, starts, lens, lines)
            t1 = time.perf_counter()
            self.seconds["pad"] += t1 - t0
            batch = self._hv.dispatch(inputs, starts, lens, lines,
                                      len(starts))
            t2 = time.perf_counter()
            self.seconds["enqueue"] += t2 - t1
            prof = _profile.active()
            if prof is not None:
                prof.device_add("h2d", t2 - t1, inputs[0].numel())
            if batch is not None:
                self.batches += 1
                return batch
            self._degrade_to(out, "count-lane overflow guard or hbm budget "
                                  "exceeded mid-stage")
        if self._handoff_live:
            self.classic_batches += 1
        return self._dispatch(buf, starts, lens, lines)

    def _wait(self, batch, cat="device", name="drain"):
        """Block until one dispatch's results are on the host (a table
        batch's wait is a ``handoff`` span, as its dispatch is)."""
        t0 = time.perf_counter()
        with devtime.track("device"), _trace.span(cat, name,
                                                  tokens=len(batch.starts)):
            if batch.event is not None:
                batch.event.synchronize()
                self.stream_seconds += batch.start.elapsed_time(
                    batch.event) / 1e3
        dt = time.perf_counter() - t0
        self.seconds["wait"] += dt
        prof = _profile.active()
        if prof is not None:
            prof.device_add("compute", dt)
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
        self._wait(batch, "handoff", "table-drain")
        t0 = time.perf_counter()
        phase = "decode"
        if not self._handoff_live:
            # The vocabulary degraded while this batch was in flight: its
            # hits left with the flush (they counted at dispatch), but its
            # misses landed nowhere.
            self._emit_table_misses(buf, batch, out, count_d2h=True)
        else:
            phase = "absorb"
            ok, miss_frac = self._hv.drain(buf, batch)
            if not ok:
                # the refused absorb landed no miss count: the flush holds
                # this batch's hits only, its misses go out on the host
                self._degrade_to(out, "vocabulary or lane budget exceeded")
                self._emit_table_misses(buf, batch, out, count_d2h=False)
            elif miss_frac > _TABLE_REVERT_MISS_FRAC:
                # the vocabulary shifted: bootstrap again
                self._hv.table_mode = False
        self.seconds[phase] += time.perf_counter() - t0

    def _drain(self, buf, batch, out=None):
        """Wait for one classic batch and build its partial-count Block (a
        collision regroups the batch on host).  While the handoff is live
        the survivors seed the vocabulary instead (returns None)."""
        from .handoff import _TABLE_ENTER_NEW_FRAC

        self._wait(batch)
        t1 = time.perf_counter()
        sh1, sh2, tot, live, rep_orig, collisions = (
            t.numpy() for t in batch.out)
        d2h_bytes = sum(t.numel() * t.element_size() for t in batch.out)
        if self.store is not None:
            self.store.count_d2h(d2h_bytes)
        prof = _profile.active()
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
        t2 = time.perf_counter()
        self.seconds["decode"] += t2 - t1
        if prof is not None:
            prof.device_add("d2h", t2 - t1, d2h_bytes)
        blk = None
        if self._handoff_live:
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
            self.seconds["absorb"] += time.perf_counter() - t2
        else:
            blk = self._emit(keys, counts, h1g, h2g)
            self.seconds["decode"] += time.perf_counter() - t2
        return blk

    def _bootstrap_on_host(self, data, out):
        """Seed an empty vocabulary from one whole window through the host
        codec (the CPU's bootstrap, :func:`.handoff._host_bootstrap`), and
        take the table program from the next window on; a vocabulary that
        does not cover it reverts through the miss bar."""
        from .handoff import CLASSIC_DRAIN_BYTES_PER_SLOT

        t0 = time.perf_counter()
        scan = chunk_doc_freq if self.dedup else chunk_token_counts
        with _trace.span("handoff", "bootstrap-host", bytes=len(data)):
            # the host grouping is codec work: traced and bucketed as such
            with devtime.track("codec"), _trace.span(
                    "codec", "codec-window", bytes=len(data)):
                blk = scan(data, self.mode, self.lower, self.pair_values)
            self.host_bootstraps += 1
            self._absorb_or_out((blk,) if blk is not None else (), out)
        if self._handoff_live and self._hv.nslots:
            self._hv.table_mode = True
            if self.store is not None and blk is not None:
                # the drain the classic path would have fetched for this
                # window, one batch's lower bound
                self.store.count_d2h_avoided(
                    CLASSIC_DRAIN_BYTES_PER_SLOT * len(blk))
        self.seconds["absorb"] += time.perf_counter() - t0
        return out

    def add(self, win):
        from . import handoff as _handoff

        data = bytes(win) if isinstance(win, memoryview) else win
        buf = np.frombuffer(data, dtype=np.uint8)
        if not len(buf):
            return ()
        out = []
        if (buf > 127).any():
            # Only valid-UTF-8 windows lower: token substrings of valid
            # UTF-8 decode losslessly, so keys can never desync from their
            # byte hash lanes or the per-line byte dedup.
            try:
                data.decode("utf-8")
            except UnicodeDecodeError:
                self._absorb_or_out(self._host_window(win), out)
                return out
        if (self._handoff_live and not self._hv.table_mode
                and not self._hv.nslots and _handoff._host_bootstrap()):
            return self._bootstrap_on_host(data, out)
        t0 = time.perf_counter()
        with devtime.track("codec"):
            if self.lower:
                buf = _LOWER[buf]
            starts, lens = _token_bounds(buf, self.mode)
            line_id = line_ids(buf, starts) if self.dedup else None
        self.seconds["scan"] += time.perf_counter() - t0
        if len(starts) == 0:
            return ()

        short = lens <= _SHORT_TOKEN
        long_idx = np.flatnonzero(~short)
        s_starts, s_lens, s_lines = starts, lens, line_id
        if len(long_idx):
            sidx = np.flatnonzero(short)
            s_starts, s_lens = starts[sidx], lens[sidx]
            s_lines = line_id[sidx] if line_id is not None else None
        ns = len(s_starts)

        bounds = (_batch_bounds(s_lines, ns, max(1024, settings.lower_batch))
                  if ns else [])
        if bounds is None:
            # The whole-window host path recounts every token, long ones
            # included, so nothing else may land for this window.
            self._absorb_or_out(self._host_window(win), out)
            return out
        if len(long_idx):
            self._absorb_or_out((self._long_tokens(buf, starts, lens, line_id,
                                                   long_idx),), out)

        # Double-buffered feed: dispatch batch i+1 before draining batch i.
        pending = None
        for a, b in bounds:
            if (pending is not None and self._handoff_live
                    and not self._hv.table_mode and not self._hv.nslots):
                # The job's first classic batch resolves before the next
                # dispatch: its drain seeds the vocabulary, so the rest of
                # the job can take the table program.
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
        return [blk for blk in out if blk is not None and len(blk)]

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
