"""The device-resident handoff: a per-job vocabulary on the device.

Port of ``dampr_tpu/ops/handoff.py``.  When the plan marks a lowered
scanner map's edge into a device-lowered associative fold
``handoff="device"`` (:func:`..plan.lower.handoff_analyze`), each map job
keeps its counts on the device instead of draining every batch to host
blocks:

- ``acc``: the per-slot count accumulator (int64 [cap + 1]; the last row
  swallows misses), advanced in place by every batch;
- ``tab_h1``/``tab_slot``: the h1 lanes of the vocabulary sorted (int32
  bit patterns in unsigned order) with their slots, which a batch probes
  by binary search;
- ``tab_mat``/``tab_lens``: each slot's token bytes, so every hit is
  verified byte for byte on the device (a hash collision can never merge
  two tokens: mismatching bytes miss to the exact host path).

Once a job's first batches have seeded the vocabulary, each later batch
runs the **table program** (:func:`table_probe`, the hand-written kernel
``csrc/handoff.cu``): FNV, the probe, the byte check and the count in one
launch (two and a ``torch.sort`` for per-line dedup over long lines).
Batches before that run the classic token fold (:mod:`.lower`), whose
drained survivors seed the table; on the CPU the job's first window seeds
it through the host codec instead (:func:`_host_bootstrap`).

At job end the accumulator becomes per-partition device-resident
:class:`~..storage.BlockRef` s that the fold (``runner._mesh_reduce``)
reads on the device.

Exactness: every count lands in a slot either verified byte-identical on
the device or through the host miss path keyed by canonical UTF-8 bytes.
A degrade (the budget exceeded, the count guard, a refused absorb)
flushes the accumulator into one hash-sorted host block and hands the
rest of the job to the classic path, with identical results.

The accumulator is int64 with :data:`_I64_GUARD`; the JAX package runs
int32 lanes with a 2^30 guard without x64.  Values are equal either way;
only the point where a huge job would degrade differs.
"""

import contextlib
import ctypes
import logging

import numpy as np
import torch

from .. import settings
from ..csrc import build
from ..obs import trace as _trace
from . import devtime
from .hashing import _FNV_OFFSET1, _FNV_PRIME1, M32, mul32

log = logging.getLogger("dampr_tpu_torch.ops.handoff")

#: Classic-drain lane bytes per padded slot a table batch never fetches:
#: sh1 (4) + sh2 (4) + tot (4) + live (1) + rep_orig (4).
CLASSIC_DRAIN_BYTES_PER_SLOT = 17

#: The bootstrap's bars: a classic batch whose new-slots-per-token
#: fraction falls under the enter bar switches the job to the table
#: program; a table batch whose miss fraction exceeds the revert bar
#: switches it back (the vocabulary shifted).  Results are equal either
#: way.
_TABLE_ENTER_NEW_FRAC = 0.20
_TABLE_REVERT_MISS_FRAC = 0.25

#: The accumulator's count guard (int64 lanes).
_I64_GUARD = 1 << 62

#: Per-line dedup span (tokens): a batch whose longest line is at most
#: this many tokens takes the kernel's windowed first-occurrence compare
#: instead of the (slot, line) sort.
_DEDUP_WINDOW = 16

#: The least number of slots a table holds (a power of two).
_MIN_CAP = 4096

_ACC_DTYPE = torch.int64

KERNEL = build.Kernel(
    "handoff.cu", "dampr_handoff",
    [ctypes.c_void_p] * 11 + [ctypes.c_longlong] + [ctypes.c_int] * 5
    + [ctypes.c_void_p])

# the kernel's modes (csrc/handoff.cu)
_COUNT, _WINDOW, _KEYS, _STARTS = 0, 1, 2, 3


def _host_bootstrap():
    """On the CPU the classic bootstrap program runs on the cores the host
    codec would use, so an empty vocabulary seeds from the job's first
    whole window through the host codec; on a card the classic program
    bootstraps while the host tokenizes the next window."""
    return settings.resolve_device().type == "cpu"


def _pow2(n, floor=_MIN_CAP):
    return max(floor, 1 << max(0, (int(n) - 1).bit_length()))


# ---------------------------------------------------------------------------
# The table program: B4
# ---------------------------------------------------------------------------


def _probe_reference(mat, lens, tab_h1, tab_slot, tab_mat, tab_lens):
    """``(slot_key, miss)`` of each row: the hit's slot or ``cap``."""
    n, L = mat.shape
    cap, Lcap = tab_mat.shape
    W = min(L, Lcap)
    h = torch.full((n,), int(_FNV_OFFSET1), dtype=torch.int64,
                   device=mat.device)
    lens64 = lens.to(torch.int64)
    for c in range(L):
        b = mat[:, c].to(torch.int64)
        h = torch.where(c < lens64, mul32(h ^ b, int(_FNV_PRIME1)), h)
    th = tab_h1.to(torch.int64) & M32
    pos = torch.searchsorted(th, h).clamp(max=cap - 1)
    cand = tab_slot[pos].to(torch.int64)
    valid = lens > 0
    same = valid & (th[pos] == h) & (tab_lens[cand] == lens)
    same &= (tab_mat[cand, :W] == mat[:, :W]).all(1)
    miss = valid & ~same
    return torch.where(same, cand, cap), miss


def table_probe_reference(mat, lens, lines, tab_h1, tab_slot, tab_mat,
                          tab_lens, acc, dedup, dedup_k=0):
    """Plain torch version of :func:`table_probe` (the CPU path and the
    card's yardstick): ``searchsorted``, gathers and ``index_add_``."""
    cap = tab_mat.shape[0]
    slot_key, miss = _probe_reference(mat, lens, tab_h1, tab_slot, tab_mat,
                                      tab_lens)
    hit = slot_key < cap
    if dedup and dedup_k:
        li = lines.to(torch.int64)
        dup = torch.zeros_like(hit)
        for k in range(1, dedup_k + 1):
            dup[k:] |= ((slot_key[k:] == slot_key[:-k]) & (li[k:] == li[:-k])
                        & hit[k:])
        acc.index_add_(0, slot_key, (hit & ~dup).to(acc.dtype))
    elif dedup:
        keys = torch.sort((slot_key << 32) | lines.to(torch.int64)).values
        first = torch.ones_like(hit)
        first[1:] = keys[1:] != keys[:-1]
        s_slot = keys >> 32
        acc.index_add_(0, s_slot, (first & (s_slot < cap)).to(acc.dtype))
    else:
        acc.index_add_(0, slot_key, hit.to(acc.dtype))
    return miss, miss.sum().to(torch.int32)


def _check(mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc):
    dev = mat.device
    if mat.dtype != torch.uint8 or mat.dim() != 2 or not mat.is_contiguous():
        raise ValueError("table_probe: mat must be a contiguous uint8 "
                         "[n, L] tensor")
    if (tab_mat.dtype != torch.uint8 or tab_mat.dim() != 2
            or not tab_mat.is_contiguous() or tab_mat.device != dev):
        raise ValueError("table_probe: tab_mat must be a contiguous uint8 "
                         "[cap, Lcap] tensor on the batch's device")
    n = mat.shape[0]
    cap = tab_mat.shape[0]
    if cap < 1 or cap >= 1 << 31:
        raise ValueError("table_probe: cap must be in [1, 2^31)")
    for what, t, size, dtype in (
            ("lens", lens, n, torch.int32), ("lines", lines, n, torch.int32),
            ("tab_h1", tab_h1, cap, torch.int32),
            ("tab_slot", tab_slot, cap, torch.int32),
            ("tab_lens", tab_lens, cap, torch.int32),
            ("acc", acc, cap + 1, _ACC_DTYPE)):
        if t is None and what == "lines":
            continue
        if (t.dtype != dtype or t.shape != (size,) or not t.is_contiguous()
                or t.device != dev):
            raise ValueError("table_probe: {} must be a contiguous {} [{}] "
                             "tensor on the batch's device".format(
                                 what, dtype, size))


def table_probe(mat, lens, lines, tab_h1, tab_slot, tab_mat, tab_lens, acc,
                dedup, dedup_k=0):
    """Probe one padded batch against a vocabulary table and add its hits'
    counts into ``acc`` in place; the torch counterpart of the reference's
    ``_table_program(n, L, cap, Lcap, dedup, ...)``.

    ``mat`` uint8 [n, L], ``lens`` int32 [n] (0 marks a pad row), ``lines``
    int32 [n] (read only under ``dedup``); ``tab_h1`` int32 [cap] (uint32
    bit patterns sorted in unsigned order, pad 0xFFFFFFFF), ``tab_slot``
    int32 [cap], ``tab_mat`` uint8 [cap, Lcap], ``tab_lens`` int32 [cap]
    (-1 empty), ``acc`` int64 [cap + 1].  Counts: +1 per hit; under
    ``dedup``, +1 per distinct ``(slot, line)`` pair, through the windowed
    compare when ``dedup_k`` (the batch's lines span at most that many
    tokens) else the sort.  Returns ``(miss bool [n], n_miss int32 0-d)``.

    On a CUDA tensor it launches ``csrc/handoff.cu`` (twice around a
    ``torch.sort`` for the sort variant); on a CPU tensor it runs
    :func:`table_probe_reference`; any other device raises."""
    if mat.device.type == "cpu":
        return table_probe_reference(mat, lens, lines, tab_h1, tab_slot,
                                     tab_mat, tab_lens, acc, dedup, dedup_k)
    if mat.device.type != "cuda":
        raise ValueError("table_probe: unsupported device {}".format(
            mat.device))
    if dedup and lines is None:
        raise ValueError("table_probe: dedup needs lines")
    _check(mat, lens, lines if dedup else None, tab_h1, tab_slot, tab_mat,
           tab_lens, acc)
    if dedup_k and not 1 <= dedup_k <= _DEDUP_WINDOW:
        raise ValueError("table_probe: dedup_k must be in [1, {}]".format(
            _DEDUP_WINDOW))
    n, L = mat.shape
    cap, Lcap = tab_mat.shape
    dev = mat.device
    miss = torch.empty(n, dtype=torch.bool, device=dev)
    n_miss = torch.empty((), dtype=torch.int32, device=dev)
    sort = dedup and not dedup_k
    keys = torch.empty(n, dtype=torch.int64, device=dev) if sort else None
    mode = _KEYS if sort else (_WINDOW if dedup else _COUNT)
    KERNEL.launch(dev, mat.data_ptr(), lens.data_ptr(),
                  lines.data_ptr() if dedup else None, tab_h1.data_ptr(),
                  tab_slot.data_ptr(), tab_mat.data_ptr(), tab_lens.data_ptr(),
                  acc.data_ptr(), miss.data_ptr(), n_miss.data_ptr(),
                  keys.data_ptr() if sort else None, n, L, cap, Lcap, mode,
                  dedup_k if dedup else 0)
    if sort and n:
        skeys = torch.sort(keys).values
        KERNEL.launch(dev, None, None, None, None, None, None, None,
                      acc.data_ptr(), None, None, skeys.data_ptr(), n, L,
                      cap, Lcap, _STARTS, 0)
    return miss, n_miss


# ---------------------------------------------------------------------------
# The per-job vocabulary
# ---------------------------------------------------------------------------


class _TableBatch(object):
    """One table-program dispatch in flight.  ``miss``/``n_miss`` are the
    host copies of its outputs, complete once ``event`` has; ``keep`` pins
    the device inputs until then; ``miss_idx`` caches the missed positions
    once fetched, so a drain that degrades can hand them to the exact host
    path."""

    __slots__ = ("miss", "n_miss", "starts", "lens", "lines", "n", "npad",
                 "miss_idx", "start", "event", "keep")

    def __init__(self, miss, n_miss, starts, lens, lines, n, npad,
                 start=None, event=None, keep=None):
        self.miss = miss
        self.n_miss = n_miss
        self.starts = starts
        self.lens = lens
        self.lines = lines
        self.n = n
        self.npad = npad
        self.miss_idx = None
        self.start = start
        self.event = event
        self.keep = keep


class HandoffVocab(object):
    """One lowered handoff job's device vocabulary and accumulator (never
    shared across jobs or threads).  ``budget`` is this job's share of the
    run's handoff budget; ``stream`` (on a card) is the stream every
    device operation of the vocabulary queues on: the sink's own, whichever
    thread calls."""

    def __init__(self, store, dedup, budget=None, device=None, stream=None):
        self.store = store
        self.dedup = dedup
        self.budget = (int(budget) if budget is not None
                       else settings.effective_handoff_budget())
        self.device = (device if device is not None
                       else settings.resolve_device())
        self.stream = stream
        self.table_batches = 0
        self.misses = 0
        self.degraded = False
        self._reset()

    def _on_stream(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _upload(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.device, non_blocking=True)

    # -- capacity ----------------------------------------------------------
    def device_bytes(self):
        if self.cap == 0:
            return 0
        return int(self.cap * (self.Lcap + 12) + (self.cap + 1) * 8)

    def _ensure_capacity(self, need_slots, need_len):
        """Grow the table (power-of-two slots and row width).  False when
        growth would exceed the budget: the caller degrades.  Rows never
        widen past ``_SHORT_TOKEN + 1`` bytes: batches carry no longer
        token, and a hit needs equal lengths, so a longer slot's bytes
        truncate (it can never verify) rather than widen every row."""
        from .text import _SHORT_TOKEN

        new_cap = self.cap
        while need_slots > new_cap:
            new_cap = _pow2(max(need_slots, _MIN_CAP, new_cap * 2))
        new_L = self.Lcap
        while need_len > new_L and new_L < _SHORT_TOKEN + 1:
            new_L *= 2
        if new_cap == self.cap and new_L == self.Lcap:
            return True
        if new_cap * (new_L + 12) + (new_cap + 1) * 8 > self.budget:
            return False
        with self._on_stream():
            acc = torch.zeros(new_cap + 1, dtype=_ACC_DTYPE,
                              device=self.device)
            if self.acc is not None and self.nslots:
                acc[:self.nslots] = self.acc[:self.nslots]
            self.acc = acc
            self.tab_mat = torch.zeros((new_cap, new_L), dtype=torch.uint8,
                                       device=self.device)
            self.tab_lens = torch.full((new_cap,), -1, dtype=torch.int32,
                                       device=self.device)
        self.cap = new_cap
        self.Lcap = new_L
        # the regrown matrices start empty: every row is staged again, and
        # the lookup lanes (sized for the old cap) must be rebuilt
        self._pending_rows = list(enumerate(self.slot_bytes))
        self._tab_dirty = True
        self._lanes_forced = True
        return True

    def _sync_table(self):
        """Publish staged rows and, when due, the rebuilt lookup lanes
        (h2d charged for what moves).  A rebuild waits until about 6% of
        the vocabulary is new (each re-sorts and re-uploads both lanes);
        a slot absent from the lanes keeps missing to the host path, which
        finds it in ``bytes2slot`` and counts it into the same row."""
        moved = 0
        with self._on_stream():
            if self._pending_rows:
                k = len(self._pending_rows)
                slots = np.fromiter((s for s, _b in self._pending_rows),
                                    dtype=np.int64, count=k)
                rows = np.zeros((k, self.Lcap), dtype=np.uint8)
                lens = np.empty(k, dtype=np.int32)
                for i, (_s, b) in enumerate(self._pending_rows):
                    w = min(len(b), self.Lcap)
                    rows[i, :w] = np.frombuffer(b[:w], dtype=np.uint8)
                    lens[i] = len(b)
                dslots = self._upload(slots)
                self.tab_mat[dslots] = self._upload(rows)
                self.tab_lens[dslots] = self._upload(lens)
                moved += slots.nbytes + rows.nbytes + lens.nbytes
                self._pending_rows = []
            if self._tab_dirty and (
                    self.tab_h1 is None or self._lanes_forced
                    or self._lanes_deferred >= max(1024, self.nslots >> 4)):
                h1a = np.asarray(self.h1, dtype=np.uint32)
                order = np.argsort(h1a, kind="stable")
                th1 = np.full(self.cap, 0xFFFFFFFF, dtype=np.uint32)
                th1[:len(order)] = h1a[order]
                tsl = np.zeros(self.cap, dtype=np.int32)
                tsl[:len(order)] = order
                self.tab_h1 = self._upload(th1.view(np.int32))
                self.tab_slot = self._upload(tsl)
                moved += th1.nbytes + tsl.nbytes
                self._tab_dirty = False
                self._lanes_forced = False
                self._lanes_deferred = 0
        if moved and self.store is not None:
            self.store.count_h2d(moved)

    # -- host-side insert and lookup -----------------------------------------
    def _insert(self, raw, key, h1, h2):
        """A new slot for canonical bytes ``raw``; -1 when the table
        cannot grow (degrade)."""
        if not self._ensure_capacity(self.nslots + 1, len(raw)):
            return -1
        slot = self.nslots
        self.nslots += 1
        self.bytes2slot[raw] = slot
        self.slot_bytes.append(raw)
        self.keys.append(key)
        self.h1.append(int(h1))
        self.h2.append(int(h2))
        self._pending_rows.append((slot, raw))
        self._tab_dirty = True
        self._lanes_deferred += 1
        return slot

    def lookup_or_insert(self, raws, keys=None, h1=None, h2=None):
        """Slots (int64) of canonical UTF-8 byte strings; unseen ones insert
        (their lanes hashed here unless given).  None when the table
        refused to grow."""
        from . import hashing

        new_at = [i for i, b in enumerate(raws) if b not in self.bytes2slot]
        if new_at and (keys is None or h1 is None):
            nk = np.empty(len(new_at), dtype=object)
            for j, i in enumerate(new_at):
                nk[j] = raws[i].decode("utf-8", "replace")
            nh1, nh2 = hashing.hash_keys(nk)
            for j, i in enumerate(new_at):
                if self._insert(raws[i], nk[j], nh1[j], nh2[j]) < 0:
                    return None
        else:
            for i in new_at:
                if self._insert(raws[i], keys[i], h1[i], h2[i]) < 0:
                    return None
        get = self.bytes2slot.get
        return np.fromiter((get(b) for b in raws), dtype=np.int64,
                           count=len(raws))

    # -- the count flow ------------------------------------------------------
    def scatter_counts(self, slots, counts):
        """Fold host-side per-slot contributions into the accumulator (one
        ``index_add_`` on the vocabulary's stream).  False past the count
        guard."""
        if not len(slots):
            return True
        counts = np.asarray(counts, dtype=np.int64)
        total = int(counts.sum())
        if self.total_added + total > _I64_GUARD:
            return False
        self.total_added += total
        self._sync_table()
        with self._on_stream():
            self.acc.index_add_(0, self._upload(np.asarray(slots,
                                                           dtype=np.int64)),
                                self._upload(counts))
        if self.store is not None:
            self.store.count_h2d(len(slots) * 16)
        return True

    def absorb_block(self, blk):
        """Fold a host-path block (long tokens, a host window, a collision
        regroup) into the accumulator, keyed by the key's canonical UTF-8
        bytes.  False when the job must degrade."""
        h1, h2 = blk.hashes()
        keys = blk.keys
        raws = [k.encode("utf-8") for k in keys]
        slots = self.lookup_or_insert(raws, keys=keys, h1=h1, h2=h2)
        if slots is None:
            return False
        return self.scatter_counts(slots, blk.values)

    def absorb_drain(self, keys, counts, h1, h2, batch_tokens):
        """Seed the table from a classic drain's survivors and fold their
        counts.  Returns ``(ok, new_fraction)``: new slots per batch token,
        the switch to table mode."""
        raws = [k.encode("utf-8") for k in keys]
        before = self.nslots
        slots = self.lookup_or_insert(raws, keys=keys, h1=h1, h2=h2)
        if slots is None:
            return False, 0.0
        new_frac = ((self.nslots - before) / float(batch_tokens)
                    if batch_tokens else 0.0)
        return self.scatter_counts(slots, counts), new_frac

    # -- the table-mode batch ------------------------------------------------
    def dispatch(self, inputs, starts, lens, lines, n):
        """Queue the table program over one padded batch (``inputs``: the
        host ``(mat, lens, lines)`` tensors, pinned on a card); the
        accumulator advances asynchronously.  Returns the drain handle, or
        None when the job must degrade (the count guard, the budget)."""
        mat_t, lens_t, lines_t = inputs
        npad = mat_t.shape[0]
        if self.total_added + n > _I64_GUARD:
            return None
        if not self._ensure_capacity(max(self.nslots, 1), self.Lcap):
            return None
        self._sync_table()
        self.total_added += n
        dedup_k = 0
        if self.dedup and lines is not None and n:
            # the longest line of the batch (line ids never decrease): one
            # within the window takes the windowed compare
            bound = np.flatnonzero(np.diff(lines)) + 1
            runs = np.diff(np.concatenate(([0], bound, [n])))
            if int(runs.max()) <= _DEDUP_WINDOW:
                dedup_k = _DEDUP_WINDOW
        nbytes = sum(t.numel() * t.element_size() for t in inputs)
        if self.store is not None:
            self.store.count_h2d(nbytes)
        cuda = self.stream is not None
        start = event = keep = None
        with devtime.track("device"), _trace.span(
                "handoff", "table-probe", tokens=int(n),
                bytes=int(nbytes)), self._on_stream():
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                start.record(self.stream)
                dev_in = [t.to(self.device, non_blocking=True)
                          for t in inputs]
            else:
                dev_in = list(inputs)
            miss, n_miss = table_probe(
                dev_in[0], dev_in[1], dev_in[2], self.tab_h1, self.tab_slot,
                self.tab_mat, self.tab_lens, self.acc, self.dedup, dedup_k)
            if cuda:
                h_miss = torch.empty(miss.shape, dtype=torch.bool,
                                     pin_memory=True)
                h_n = torch.empty((), dtype=torch.int32, pin_memory=True)
                h_miss.copy_(miss, non_blocking=True)
                h_n.copy_(n_miss, non_blocking=True)
                event = torch.cuda.Event(enable_timing=True)
                event.record(self.stream)
                keep = (inputs, dev_in, miss, n_miss)
                miss, n_miss = h_miss, h_n
        self.table_batches += 1
        return _TableBatch(miss, n_miss, starts, lens, lines, n, npad,
                           start, event, keep)

    def drain(self, buf, batch):
        """Resolve one table dispatch: absorb its misses exactly on the
        host and credit the drain bytes the classic program would have
        fetched.  Returns ``(ok, miss_fraction)``; ``ok`` False means no
        miss count landed (the absorb is transactional: slots inserted
        before the refusal carry zero counts, which the degrade flush
        drops), and the caller must emit ``batch.miss_idx``'s tokens
        through the exact host path or they are lost."""
        n_miss = int(batch.n_miss)
        fetched = 4 + batch.npad  # n_miss and the miss lane both come back
        ok = True
        self.misses += n_miss
        if n_miss:
            idx = np.flatnonzero(batch.miss.numpy()[:batch.n])
            batch.miss_idx = idx
            ok = self._absorb_miss_tokens(
                buf, batch.starts[idx], batch.lens[idx],
                batch.lines[idx] if batch.lines is not None else None)
        if self.store is not None:
            self.store.count_d2h(fetched)
            if ok:
                # only a batch that stayed on the tier claims the drain
                self.store.count_d2h_avoided(max(
                    0, CLASSIC_DRAIN_BYTES_PER_SLOT * batch.npad - fetched))
        return ok, (n_miss / float(batch.n) if batch.n else 0.0)

    def _absorb_miss_tokens(self, buf, starts, lens, lines):
        """Exact host grouping of a batch's missed tokens (the grouping the
        classic collision path uses), then insert and scatter."""
        from .text import group_token_rows

        if not len(starts):
            return True
        uniq, counts = group_token_rows(buf, starts, lens, lines,
                                        self.dedup and lines is not None)
        raws = [uniq[i, 1:1 + int(uniq[i, 0])].tobytes()
                for i in range(len(uniq))]
        slots = self.lookup_or_insert(raws)
        if slots is None:
            return False
        return self.scatter_counts(slots, counts)

    # -- the end of a job ------------------------------------------------------
    def flush_block(self):
        """The degrade: one fetch of the accumulator into a hash-sorted
        host block, equal to what the classic combine would have built;
        the job goes on down the spill path."""
        from ..blocks import Block

        if self.nslots == 0:
            self._reset()
            return None
        with self._on_stream():
            counts = self.acc[:self.nslots].cpu().numpy()
        if self.store is not None:
            self.store.count_d2h(counts.nbytes)
        keys = np.empty(self.nslots, dtype=object)
        keys[:] = self.keys
        h1 = np.asarray(self.h1, dtype=np.uint32)
        h2 = np.asarray(self.h2, dtype=np.uint32)
        keep = counts > 0
        blk = Block(keys[keep], counts[keep], h1[keep], h2[keep])
        self._reset()
        if not len(blk):
            return None
        return blk.sort_by_hash()

    def degrade(self, reason):
        self.degraded = True
        if self.store is not None:
            self.store.count_handoff_degrade()
        _trace.instant("handoff", "degrade", reason=reason)
        log.info("handoff degraded to the spill path: %s", reason)
        return self.flush_block()

    def _reset(self):
        self.acc = None
        self.tab_h1 = self.tab_slot = None
        self.tab_mat = self.tab_lens = None
        self.cap = 0
        self.Lcap = 8
        self.nslots = 0
        self.total_added = 0
        self.bytes2slot = {}
        self.keys = []        # the decoded key of each slot
        self.slot_bytes = []  # its canonical UTF-8 bytes
        self.h1 = []          # its hash lanes (Python ints)
        self.h2 = []
        self._pending_rows = []  # (slot, bytes) not yet on the device
        self._tab_dirty = True
        self._lanes_forced = False
        self._lanes_deferred = 0
        self.table_mode = False

    def finalize(self, store, n_partitions):
        """Job end: the accumulator becomes per-partition device-resident
        refs, hash-sorted within each partition (the layout the classic
        combine registers), entered into ``store``'s device tier.  Returns
        ``(blocks, {pid: [BlockRef]})``, at most one side non-empty
        (``blocks`` is a degrade flush for the classic path).

        The refs' lanes are made on the vocabulary's stream; each carries
        an event recorded after them, which a reader on another stream
        waits on (``BlockRef.device_lanes``)."""
        from ..storage import BlockRef

        if self.degraded or self.nslots == 0:
            self._reset()
            return (), {}
        if self.device_bytes() + self.nslots * 16 > self.budget:
            blk = self.degrade("hbm budget exceeded at finalize")
            return ((blk,) if blk is not None else ()), {}
        h1 = np.asarray(self.h1, dtype=np.uint32)
        h2 = np.asarray(self.h2, dtype=np.uint32)
        order = np.lexsort((h2, h1))
        pid = (h1[order] % np.uint32(n_partitions)).astype(np.int32)
        porder = np.argsort(pid, kind="stable")
        perm = order[porder]
        sorted_pid = pid[porder]
        bounds = np.flatnonzero(np.diff(sorted_pid)) + 1
        starts = np.concatenate(([0], bounds)).astype(np.int64)
        ends = np.concatenate((bounds, [self.nslots])).astype(np.int64)
        keys = np.empty(self.nslots, dtype=object)
        keys[:] = self.keys
        sh1, sh2 = h1[perm], h2[perm]
        ready = None
        with devtime.track("device"), _trace.span(
                "handoff", "finalize", records=int(self.nslots)), \
                self._on_stream():
            vals = self.acc.index_select(0, self._upload(perm.astype(
                np.int64)))
            dev_h1 = self._upload(sh1.view(np.int32))
            dev_h2 = self._upload(sh2.view(np.int32))
            csum = torch.cat([vals.new_zeros(1), torch.cumsum(vals, 0)])
            seg = csum[self._upload(ends)] - csum[self._upload(starts)]
            # one fetch (it waits for the stream): each partition's sum and
            # the smallest count
            meta = torch.cat([seg, vals.min().view(1)]).cpu().numpy()
            # each partition's lanes copied out, so a ref owns its memory:
            # offloading or dropping one frees what its store uncharges
            lanes = [tuple(t[s:e].clone() for t in (vals, dev_h1, dev_h2))
                     for s, e in zip(starts.tolist(), ends.tolist())]
            del vals, dev_h1, dev_h2, csum, seg
            if self.stream is not None:
                ready = torch.cuda.Event()
                ready.record(self.stream)
        if self.store is not None:
            self.store.count_h2d(perm.nbytes + 16 * len(starts))
        lane_min = int(meta[-1])
        mapping = {}
        total_dev = 0
        for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            ref = BlockRef.from_device_lanes(
                keys[perm[s:e]], sh1[s:e], sh2[s:e], *lanes[i],
                store=store, value_dtype=np.int64,
                lane_abs=int(meta[i]), lane_min=lane_min,
                h2d_bytes=8 * (e - s), ready=ready)
            store.register_device(ref)
            total_dev += ref.dev_bytes
            mapping.setdefault(int(sorted_pid[s]), []).append(ref)
        _trace.instant("handoff", "registered", bytes=int(total_dev),
                       partitions=len(mapping))
        self._reset()
        return (), mapping
