"""Segmented fold over hash-sorted records: the K2 kernel.

Port of the TPU kernel ``dampr_tpu/ops/pallas_segfold.py::segfold_sorted``.
One CUDA source, ``csrc/segfold.cu`` (a single-pass scan with decoupled
look-back; its header gives the design and the bound), serves two entries:

- :func:`segfold` — ``segfold_sorted``'s contract: for int32 lanes sorted
  by ``(inv, h1, h2)``, ``tot[j]`` is the sum of ``v`` over the segment
  ending at ``j`` and ``live[j] = end(j) & inv[j] == 0``, both 0 where
  ``j`` is not a segment end;
- :func:`segfold_gather` — the whole of :func:`.lower.token_fold` after
  its sort: from the sorting permutation, the sorted high keys and the
  unsorted low keys of :func:`.fnv.fnv_sort_keys` and the token rows, in
  one launch, the program's six outputs: the sorted lanes, ``tot`` and
  ``live`` (with per-line first-occurrence contributions under dedup),
  each position's segment representative and the byte-exact collision
  count.

On CUDA tensors each launches the kernel; on CPU tensors it runs its plain
torch version (:func:`segfold_reference_torch`,
:func:`segfold_gather_reference`), the adj_new/cumsum/cummax chain and the
collision check of ``dampr_tpu/ops/lower.py:140-180``.  Any other device
raises.  Any N up to 2^30 works; no tile padding.

Exactness (both versions): the nonneg contract — every ``v >= 0`` and the
global sum fits int32 — keeps the int32 prefix arithmetic exact.
"""

import ctypes

import torch

from ..csrc import build
from .fnv import unpack_sort_keys
from .hashing import lanes_to_int32

#: Records per tile in ``csrc/segfold.cu`` (THREADS * ITEMS there).
_TILE = 512
#: Largest N the kernel takes (its status words hold 30-bit positions).
MAX_N = 1 << 30

KERNEL = build.Kernel(
    "segfold.cu", "dampr_segfold",
    [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])

# the kernel's modes (csrc/segfold.cu)
_CONTRACT, _GATHER, _GATHER_DEDUP = 0, 1, 2


def adj_new(*lanes):
    """True where any lane differs from its predecessor (position 0
    inclusive): the segment starts of sorted lanes."""
    n = lanes[0].shape[0]
    out = torch.ones(n, dtype=torch.bool, device=lanes[0].device)
    if n > 1:
        neq = torch.zeros(n - 1, dtype=torch.bool, device=lanes[0].device)
        for lane in lanes:
            neq |= lane[1:] != lane[:-1]
        out[1:] = neq
    return out


def _fold(starts, v, inv):
    """``(tot, live)`` of segments marked by ``starts``."""
    n = starts.shape[0]
    csum = torch.cumsum(v, 0, dtype=torch.int32)
    ex = csum - v
    # ex is nondecreasing (v >= 0), so a running max over start-marked
    # values carries each segment's exclusive prefix to its records
    start_ex = torch.cummax(torch.where(starts, ex, -1), 0).values
    ends = torch.ones(n, dtype=torch.bool, device=starts.device)
    if n > 1:
        ends[:-1] = starts[1:]
    tot = torch.where(ends, csum - start_ex, 0).to(torch.int32)
    live = ends & (inv == 0)
    return tot, live


def segfold_reference_torch(h1, h2, v, inv):
    """Plain torch version of :func:`segfold`: ``(tot int32, live bool)``."""
    return _fold(adj_new(inv, h1, h2), v, inv)


def segment_marks(shigh, slow, dedup):
    """Segment starts and contributions of records in sorted order, from
    their sort keys (``slow = low[perm]``): a segment is a run of equal
    ``(inv, h1, h2)``; ``v`` is 1 for a valid record, under dedup only for
    the first of its run of equal ``(inv, h1, h2, line)``."""
    _, u2, inv = unpack_sort_keys(slow, shigh, dedup)
    starts = adj_new(shigh, u2)
    valid = inv == 0
    v = (adj_new(shigh, slow) & valid) if dedup else valid
    return starts, v.to(torch.int32)


def start_positions(starts):
    """Each position's segment start (int64), from the start marks."""
    pos = torch.arange(starts.shape[0], device=starts.device)
    return torch.cummax(torch.where(starts, pos, -1), 0).values


def segfold_gather_reference(perm, shigh, low, mat, lens, dedup):
    """Plain torch version of :func:`segfold_gather`."""
    slow = low[perm]
    starts, v = segment_marks(shigh, slow, dedup)
    u1, u2, sinv = unpack_sort_keys(slow, shigh, dedup)
    sinv = sinv.to(torch.int32)
    tot, live = _fold(starts, v, sinv)
    start_pos = start_positions(starts)
    sh1, sh2 = lanes_to_int32(u1), lanes_to_int32(u2)
    # collision check: every valid token's row equals its segment rep's
    rep_orig = perm[start_pos]
    same = (lens[perm] == lens[rep_orig]) & (mat[perm] == mat[rep_orig]).all(1)
    collisions = ((sinv == 0) & ~same).sum()
    return sh1, sh2, tot, live, rep_orig.to(torch.int32), collisions


def _check(name, lanes, dtype, device):
    n = lanes[0][1].numel()
    if n > MAX_N:
        raise ValueError("{}: N = {} exceeds the kernel's 2^30".format(name,
                                                                     n))
    for what, t in lanes:
        if (t.dtype != dtype or t.dim() != 1 or t.shape[0] != n
                or not t.is_contiguous() or t.device != device):
            raise ValueError("{}: {} must be a contiguous {} [N] tensor on "
                             "{}".format(name, what, dtype, device))
    return n


def _buffer(n, device, rows):
    """One int32 allocation: ``rows`` output rows of ``n`` (each padded to
    a multiple of 16 elements, at least 16, so every row is 16-byte
    aligned), then a row for the live mask's bytes and one for the
    kernel's scratch (its tile counter, the collision count and the status
    words, 16 + n / 64 bytes).  Returns ``(output rows, live, the scratch
    row, the scratch pointer)``."""
    n16 = max(16, -(-n // 16) * 16)
    buf = torch.empty((rows + 2, n16), dtype=torch.int32, device=device)
    out = buf.unbind(0)
    live = out[rows].view(torch.bool)[:n]
    scratch = out[rows + 1]
    out = out[:rows] if n16 == n else [r[:n] for r in out[:rows]]
    return out, live, scratch, scratch.data_ptr()


def segfold(h1, h2, v, inv):
    """Segment totals at segment ends of int32 lanes sorted by
    ``(inv, h1, h2)`` (hash lanes as int32 bit patterns, ``v >= 0``,
    ``inv`` 0 for valid records).  Returns ``(tot int32, live bool)``."""
    if h1.device.type == "cpu":
        return segfold_reference_torch(h1, h2, v, inv)
    if h1.device.type != "cuda":
        raise ValueError("segfold: unsupported device {}".format(h1.device))
    n = _check("segfold", (("h1", h1), ("h2", h2), ("v", v), ("inv", inv)),
               torch.int32, h1.device)
    (tot,), live, _, scratch = _buffer(n, h1.device, 1)
    if n:
        KERNEL.launch(h1.device, h1.data_ptr(), h2.data_ptr(), v.data_ptr(),
                      inv.data_ptr(), None, tot.data_ptr(), live.data_ptr(),
                      None, None, None, scratch, n, 0, _CONTRACT)
    return tot, live


def segfold_gather(perm, shigh, low, mat, lens, dedup):
    """The token fold's stage after its sort, over records in sorted order.

    ``perm`` int64 [N] orders the rows; ``shigh`` int64 [N] is the high
    sort key in that order and ``low`` int64 [N] the low key in row order
    (both from :func:`.fnv.fnv_sort_keys`, with the line when ``dedup``);
    ``mat`` uint8 [N, L] and ``lens`` int32 [N] are the token rows the keys
    hash.  Returns :func:`.lower.token_fold`'s six outputs
    ``(sh1, sh2, tot, live, rep_orig, collisions)``: the sorted hash lanes
    as int32 bit patterns, the segment totals at segment ends (int32), the
    live-end mask (bool), each position's segment representative as a row
    index (int32) and the count of valid rows whose length or bytes differ
    from their representative's (0-d int64)."""
    if perm.device.type == "cpu":
        return segfold_gather_reference(perm, shigh, low, mat, lens, dedup)
    if perm.device.type != "cuda":
        raise ValueError("segfold_gather: unsupported device {}".format(
            perm.device))
    n = _check("segfold_gather", (("perm", perm), ("shigh", shigh),
                                  ("low", low)), torch.int64, perm.device)
    _check("segfold_gather", (("lens", lens),), torch.int32, perm.device)
    if (mat.dtype != torch.uint8 or mat.dim() != 2 or mat.shape[0] != n
            or not mat.is_contiguous() or mat.device != perm.device):
        raise ValueError("segfold_gather: mat must be a contiguous uint8 "
                         "[N, L] tensor on {}".format(perm.device))
    (sh1, sh2, tot, rep), live, srow, scratch = _buffer(n, perm.device, 4)
    collisions = srow[2:4].view(torch.int64)[0]  # scratch bytes 8-15
    if n:
        KERNEL.launch(perm.device, perm.data_ptr(), shigh.data_ptr(),
                      low.data_ptr(), lens.data_ptr(), mat.data_ptr(),
                      tot.data_ptr(), live.data_ptr(), sh1.data_ptr(),
                      sh2.data_ptr(), rep.data_ptr(), scratch, n,
                      mat.shape[1], _GATHER_DEDUP if dedup else _GATHER)
    else:
        collisions.zero_()
    return sh1, sh2, tot, live, rep, collisions
