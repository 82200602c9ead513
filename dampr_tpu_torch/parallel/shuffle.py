"""The keyed fold on one device: local fold, refold, compaction.

Port of ``dampr_tpu/parallel/shuffle.py`` for one device (D = 1), where
its program degenerates to one local fold: the routing by ``h1 % D``, the
capacity buffers and the ``all_to_all`` move nothing, so they are not
built here; they come with the multi-card slice.  ``runner._mesh_reduce``
folds the device-resident map outputs (the HBM tier, the handoff) and its
host windows through these functions and fetches one result.

A fold's lanes are torch tensors on the device: ``h1``/``h2`` int32 (the
uint32 hash lanes' bit patterns), ``v`` int64, ``ok`` int32 (1 marks a
live row).  Every lane is int64 where the reference's are int32 without
x64, so the reference's 32-bit guards become the int64 ones of its x64
branch.

:func:`_local_fold` sorts by ``(invalid, h1, h2)`` (torch has no
multi-key sort: a stable sort on the packed order-preserving hash key,
then a stable sort on the invalid flag) and folds each run:

- a non-negative sum whose total fits int32 takes the scan lowering
  through K2 (:func:`..ops.segfold.segfold`, ``segfold_sorted``'s contract;
  its prefix arithmetic is int32);
- any other sum, ``min`` and ``max`` fold into segment slots with
  ``index_add_``/``scatter_reduce`` in int64, the port's device fold.
"""

import numpy as np
import torch

from .. import settings
from ..obs import trace as _trace
from ..ops import devtime
from ..ops import segfold as _segfold
from ..ops.hashing import M32
from ..ops.segment import packed_lane_key

_I32_MAX = 2 ** 31 - 1
_I64_MAX = 2 ** 63 - 1


def _pad_pow2(n, floor=8):
    return max(floor, 1 << max(0, (n - 1).bit_length()))


def _sort_lanes(inv, h1, h2, v):
    """The lanes stably sorted by ``(inv, h1, h2)`` in unsigned order:
    two stable passes, least significant key first."""
    key = packed_lane_key(h1.to(torch.int64) & M32, h2.to(torch.int64) & M32)
    _, p = torch.sort(key, stable=True)
    _, q = torch.sort(inv[p], stable=True)
    perm = p[q]
    return inv[perm], h1[perm], h2[perm], v[perm]


def _local_fold(inv, h1, h2, v, kind, nonneg_sum=False):
    """Sort by ``(inv, h1, h2)`` and fold each run of equal lanes.
    Returns ``(inv, h1, h2, v)`` of the same length, one live row (inv 0)
    per segment, the rest dead (inv 1)."""
    inv, h1, h2, v = _sort_lanes(inv, h1, h2, v)
    starts = _segfold.adj_new(inv, h1, h2)
    if (nonneg_sum and kind == "sum"
            and int(v.sum()) <= _I32_MAX):
        return _scan_fold_sorted(inv, h1, h2, v)
    n = h1.shape[0]
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    folded = torch.zeros_like(v)
    if kind == "sum":
        folded.index_add_(0, seg, v)
    elif kind in ("min", "max"):
        folded.scatter_reduce_(0, seg, v, reduce="a" + kind,
                               include_self=False)
    else:
        raise ValueError(kind)
    at = torch.nonzero(starts).squeeze(1)
    ns = at.shape[0]
    seg_h1 = torch.zeros_like(h1)
    seg_h2 = torch.zeros_like(h2)
    seg_h1[:ns] = h1[at]
    seg_h2[:ns] = h2[at]
    # invalid rows sort last and form all-invalid segments
    live = torch.zeros(n, dtype=torch.bool, device=h1.device)
    live[:ns] = inv[at] == 0
    return ((~live).to(torch.int32), seg_h1, seg_h2, folded)


def _scan_fold_sorted(inv, h1, h2, v):
    """The nonneg-sum lowering after the sort: segment totals at segment
    ends, through K2 (the caller proved every value >= 0 and the total
    within int32)."""
    tot, live = _segfold.segfold(h1, h2, v.to(torch.int32), inv)
    return ((~live).to(torch.int32), h1, h2, tot.to(torch.int64))


def _lane_safe_values(v, kind):
    """The int64 lane of a value column, or ValueError where the device
    fold would not give the host fold's values: object lanes, floats (the
    port folds float lanes on the host: a device sum has no fixed order)
    and uint64 values past int64."""
    if v.dtype == object:
        raise ValueError("object values cannot ride the device fold lanes")
    if v.dtype == np.bool_ or v.dtype.kind in "iu":
        if v.dtype == np.uint64 and len(v) and int(v.max()) > _I64_MAX:
            raise ValueError("uint64 values exceed the int64 fold lanes")
        return v.astype(np.int64)
    raise ValueError("{} values fold on the host".format(v.dtype))


def _fold(inv, h1, h2, v, kind, nonneg):
    # host seconds queueing the fold (its sums and the K2 launch); the
    # card's work surfaces where the caller fetches
    with devtime.track("device"), _trace.span(
            "collective", "keyed-fold:{}".format(kind),
            records=int(h1.shape[0])):
        inv, h1, h2, v = _local_fold(inv, h1, h2, v, kind, nonneg)
        return h1, h2, v, (inv == 0).to(torch.int32)


def _padded(lanes, n_pad):
    """Each lane zero-padded to ``n_pad`` rows on its device."""
    out = []
    for t in lanes:
        p = torch.zeros((n_pad,), dtype=t.dtype, device=t.device)
        p[:t.shape[0]] = t
        out.append(p)
    return out


def mesh_keyed_fold(h1, h2, v, kind="sum", device=None):
    """The keyed fold of one device over host lanes, kept on the device:
    one live row per distinct ``(h1, h2)`` pair, in unspecified order, as
    the padded ``(h1, h2, v, ok)`` tensors (the reference's ``raw=True``),
    so a caller folding many windows re-folds partials with
    :func:`mesh_keyed_refold` and fetches once.

    ``h1``/``h2`` uint32 numpy lanes, ``v`` numeric values (ValueError for
    lanes :func:`_lane_safe_values` refuses)."""
    dev = device if device is not None else settings.resolve_device()
    v = _lane_safe_values(np.asarray(v), kind)
    total = len(h1)
    if total == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, torch.zeros(0, dtype=torch.int64, device=dev), z
    # the scan lowering: non-negative values whose sum cannot wrap int64
    # (the total's int32 bound is checked after the sort, on the device)
    nonneg = (kind == "sum" and int(v.min()) >= 0
              and total * int(v.max()) <= _I64_MAX)
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (np.asarray(h1, dtype=np.uint32).view(np.int32),
                       np.asarray(h2, dtype=np.uint32).view(np.int32), v)]
    n_pad = _pad_pow2(total)
    ph1, ph2, pv = _padded(lanes, n_pad)
    inv = (torch.arange(n_pad, device=dev) >= total).to(torch.int32)
    return _fold(inv, ph1, ph2, pv, kind, nonneg)


def mesh_keyed_refold(parts, kind, nonneg=False):
    """Fold device-resident partials (``(h1, h2, v, ok)`` tuples from
    :func:`mesh_keyed_fold`, or a device ref's lanes)
    into one, on the device.  Lane safety is the caller's: it bounds the
    absolute sum over everything it folded."""
    h1 = torch.cat([p[0] for p in parts])
    h2 = torch.cat([p[1] for p in parts])
    v = torch.cat([p[2] for p in parts])
    ok = torch.cat([p[3] for p in parts])
    n_pad = _pad_pow2(h1.shape[0])
    if n_pad != h1.shape[0]:
        h1, h2, v, ok = _padded((h1, h2, v, ok), n_pad)
    return _fold((ok != 1).to(torch.int32), h1, h2, v, kind, nonneg)


def _live_prefix_sort(h1, h2, v, ok):
    """The lanes stably sorted with the live rows first."""
    _, order = torch.sort((ok != 1).to(torch.int32), stable=True)
    return h1[order], h2[order], v[order]


def compact_partial(part):
    """Shrink a device partial to a power-of-two pad of its live rows.
    A refold's output is as long as its input, dead rows included, so
    partials folded again and again would carry ever more dead rows; one
    validity sort and a slice bound each at its distinct keys.  One scalar
    fetch (the live count)."""
    h1, h2, v, ok = part
    n = int(h1.shape[0])
    if n == 0:
        return part
    nlive = int((ok == 1).sum())
    m = _pad_pow2(max(1, nlive))
    if m >= n:
        return part
    sh1, sh2, sv = _live_prefix_sort(h1, h2, v, ok)
    okc = (torch.arange(m, device=h1.device) < nlive).to(torch.int32)
    return sh1[:m], sh2[:m], sv[:m], okc
