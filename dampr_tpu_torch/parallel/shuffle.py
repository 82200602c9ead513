"""The mesh keyed shuffle: local fold -> all_to_all -> final fold (B7).

Port of ``dampr_tpu/parallel/shuffle.py``.  On a mesh of D shards each
shard runs the reference's ``_build_fold_program`` over its lanes:

1. **local fold** (:func:`_local_fold`): sort by ``(invalid, h1, h2)``
   and fold each run, so at most one row per distinct key crosses;
2. **pack** (:func:`_pack_by_dest`): destination ``h1 % D``; a stable
   sort by ``(invalid, destination)`` and each row's rank in its
   destination group place the live rows in a ``[D, C]`` buffer per lane,
   with the rows past the capacity C counted as dropped;
3. **all_to_all** of the four lanes (:func:`.mesh.all_to_all`);
4. **final fold** of everything received;
5. **psum** of the dropped counts: the caller doubles C and reruns until
   nothing was dropped, so the result never loses a row.

The output is sharded: each shard's padded lanes, concatenated in shard
order.  Across processes (the ``gather`` variant) every rank runs its
local shards and an all_gather of the four output lanes gives each rank
the whole output, as the JAX package's multi-process program does.  On a
mesh of one shard the program is the local fold alone (no pack, no
copy): the routing moves nothing there.

Lanes are torch tensors on the shards' devices: ``h1``/``h2`` int32 (the
uint32 hash lanes' bit patterns), ``v`` int64 (float32 for float32
values), ``ok`` int32 (1 marks a live row).  Integer lanes are int64
where the reference's are int32 without x64, so the reference's 32-bit
guards become the int64 ones of its x64 branch.  Destinations are
computed on the hash as int64 masked to 32 bits (torch's ``%`` on int32
would see negative values).  torch has no multi-key sort: ``(invalid,
h1, h2)`` is a stable sort on the packed order-preserving hash key, then
a stable sort on the invalid flag, and ``(invalid, destination)`` one
stable sort of ``invalid * D + destination``.

A local fold's non-negative sum whose total fits int32 takes the scan
lowering through K2 (:func:`..ops.segfold.segfold`, ``segfold_sorted``'s
contract: its prefix arithmetic is int32); any other sum, ``min`` and
``max`` fold into segment slots with ``index_add_``/``scatter_reduce``.
"""

import numpy as np
import torch

from .. import settings
from ..obs import trace as _trace
from ..ops import devtime
from ..ops import segfold as _segfold
from ..ops.hashing import M32
from ..ops.segment import packed_lane_key
from . import mesh as _mesh

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


def _pack_by_dest(inv, h1, h2, v, n_dev, capacity):
    """The live rows of one shard in fixed ``[D, C]`` buffers by
    destination ``h1 % D``.  Returns ``(ok, h1, h2, v, n_dropped)``: the
    four buffers (``ok`` 1 on a filled slot) and the live rows past C."""
    n = h1.shape[0]
    dev = h1.device
    dest = (h1.to(torch.int64) & M32) % n_dev
    key = inv.to(torch.int64) * n_dev + dest
    skey, order = torch.sort(key, stable=True)
    dest, h1, h2, v = dest[order], h1[order], h2[order], v[order]
    valid = inv[order] == 0
    iota = torch.arange(n, device=dev)
    new_group = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        new_group[1:] = skey[1:] != skey[:-1]
    start, _ = torch.cummax(torch.where(new_group, iota,
                                        torch.zeros_like(iota)), 0)
    rank = iota - start
    keep = valid & (rank < capacity)
    dropped = (valid & (rank >= capacity)).sum()
    flat = n_dev * capacity
    # one extra slot swallows the rows that are not kept
    slot = torch.where(keep, dest * capacity + rank,
                       torch.full_like(rank, flat))
    shape = (n_dev, capacity)

    def place(lane):
        buf = torch.zeros(flat + 1, dtype=lane.dtype, device=dev)
        buf[slot] = lane
        return buf[:flat].reshape(shape)

    return (place(keep.to(torch.int32)), place(h1), place(h2), place(v),
            dropped)


def _lane_safe_values(v, kind):
    """The device lane of a value column, or ValueError where the device
    fold would not give the host fold's values: object lanes, float64
    (float32 precision would change it) and uint64 values past int64.
    Integers ride int64; float32 and float16 ride float32."""
    if v.dtype == object:
        raise ValueError("object values cannot ride the device fold lanes")
    if v.dtype in (np.float32, np.float16):
        return v.astype(np.float32)
    if v.dtype == np.bool_ or v.dtype.kind in "iu":
        if v.dtype == np.uint64 and len(v) and int(v.max()) > _I64_MAX:
            raise ValueError("uint64 values exceed the int64 fold lanes")
        return v.astype(np.int64)
    raise ValueError("{} values fold on the host".format(v.dtype))


def _one_shard_fold(inv, h1, h2, v, kind, nonneg):
    """The program on a mesh of one shard: the local fold alone."""
    with devtime.track("device"), _trace.span(
            "collective", "keyed-fold:{}".format(kind),
            records=int(h1.shape[0])):
        inv, h1, h2, v = _local_fold(inv, h1, h2, v, kind, nonneg)
        return h1, h2, v, (inv == 0).to(torch.int32)


def _fold_program(mesh, lanes, capacity, kind, nonneg):
    """One run of the program over D shards.  ``lanes[l]`` is local shard
    l's ``(inv, h1, h2, v)`` on its device.  Returns the output ``(h1,
    h2, v, ok)`` of every shard in shard order (across processes through
    the all_gather of the ``gather`` variant) and the psum of the dropped
    rows."""
    D = _mesh.mesh_size(mesh)
    packed, dropped = [], []
    for inv, h1, h2, v in lanes:
        inv, h1, h2, v = _local_fold(inv, h1, h2, v, kind, nonneg)
        *bufs, drop = _pack_by_dest(inv, h1, h2, v, D, capacity)
        packed.append(bufs)
        dropped.append(drop)
    recv = [_mesh.all_to_all(mesh, [p[i] for p in packed])
            for i in range(4)]
    flat = D * capacity
    out = []
    for d in range(len(mesh.devices)):
        rok, rh1, rh2, rv = (r[d].reshape(flat) for r in recv)
        inv2, fh1, fh2, fv = _local_fold(
            (rok != 1).to(torch.int32), rh1, rh2, rv, kind, nonneg)
        out.append((fh1, fh2, fv, (inv2 == 0).to(torch.int32)))
    total_dropped = int(_mesh.psum(mesh, dropped)[0])
    if mesh.nproc > 1:
        # gather: every rank reads the whole output
        return (tuple(_mesh.all_gather(mesh, [o[i] for o in out])[0]
                      for i in range(4)), total_dropped)
    return (tuple(_mesh.unshard(mesh, [o[i] for o in out])
                  for i in range(4)), total_dropped)


#: Runs of the fold program over more than one shard, and the reruns
#: among them after an overflow (the capacity doubled each time), since
#: import.
program_runs = 0
retries = 0


def _run_fold_padded(mesh, h1, h2, v, valid, n_local, kind, nonneg,
                     factor):
    """The capacity-retry loop over padded lanes (``D * n_local`` rows):
    run the program, double the capacity on overflow."""
    global program_runs, retries
    D = _mesh.mesh_size(mesh)
    capacity = max(8, int(-(-n_local // D) * factor))
    lanes = list(zip(*(_mesh.shard(mesh, t) for t in (
        (valid != 1).to(torch.int32), h1, h2, v))))
    while True:
        with devtime.track("device"), _trace.span(
                "collective", "keyed-fold:{}".format(kind),
                records=int(n_local * D), capacity=int(capacity)):
            out, dropped = _fold_program(mesh, lanes, capacity, kind,
                                         nonneg)
        program_runs += 1
        if dropped == 0:
            return out
        retries += 1
        capacity *= 2


def _nonneg(v, kind):
    """May the fold take the scan lowering?  An integer sum of values
    >= 0 whose sum cannot wrap int64 (the int32 bound of K2's prefix is
    checked per fold, on the device)."""
    return (kind == "sum" and v.dtype.kind == "i"
            and (not len(v) or (int(v.min()) >= 0
                                and len(v) * int(v.max()) <= _I64_MAX)))


def mesh_keyed_fold(mesh, h1, h2, v, kind="sum", capacity_factor=None,
                    raw=False):
    """The keyed fold over ``mesh`` of host lanes: one live row per
    distinct ``(h1, h2)`` pair, in unspecified order.  Returns the live
    rows as numpy ``(h1, h2, v)`` (``h1``/``h2`` uint32), or with
    ``raw=True`` the padded ``(h1, h2, v, ok)`` tensors on the device, so
    a caller folding many windows re-folds partials with
    :func:`mesh_keyed_refold` and fetches once.  Retries with doubled
    capacity on overflow, so the result is complete whatever the skew.

    ``h1``/``h2`` uint32 numpy lanes, ``v`` numeric values (ValueError for
    lanes :func:`_lane_safe_values` refuses)."""
    v = _lane_safe_values(np.asarray(v), kind)
    dev = mesh.devices[0]
    D = _mesh.mesh_size(mesh)
    total = len(h1)
    if total == 0:
        if raw:
            z = torch.zeros(0, dtype=torch.int32, device=dev)
            return z, z, torch.from_numpy(v[:0]).to(dev), z
        return (np.empty(0, np.uint32), np.empty(0, np.uint32), v[:0])
    nonneg = _nonneg(v, kind)
    lanes = [torch.from_numpy(np.require(a, requirements="CW")).to(dev)
             for a in (np.asarray(h1, dtype=np.uint32).view(np.int32),
                       np.asarray(h2, dtype=np.uint32).view(np.int32), v)]
    if D == 1:
        n_pad = _pad_pow2(total)
        ph1, ph2, pv = _padded(lanes, n_pad)
        inv = (torch.arange(n_pad, device=dev) >= total).to(torch.int32)
        out = _one_shard_fold(inv, ph1, ph2, pv, kind, nonneg)
    else:
        n_local = _pad_pow2(-(-total // D))
        ph1, ph2, pv = _padded(lanes, n_local * D)
        valid = (torch.arange(n_local * D, device=dev) < total).to(
            torch.int32)
        out = _run_fold_padded(
            mesh, ph1, ph2, pv, valid, n_local, kind, nonneg,
            capacity_factor or settings.shuffle_capacity_factor)
    if raw:
        return out
    fh1, fh2, fv, ok = out
    mask = ok == 1
    return (fh1[mask].cpu().numpy().view(np.uint32),
            fh2[mask].cpu().numpy().view(np.uint32), fv[mask].cpu().numpy())


def _padded(lanes, n_pad):
    """Each lane zero-padded to ``n_pad`` rows on its device."""
    out = []
    for t in lanes:
        p = torch.zeros((n_pad,), dtype=t.dtype, device=t.device)
        p[:t.shape[0]] = t
        out.append(p)
    return out


def mesh_keyed_refold(mesh, parts, kind, nonneg=False,
                      capacity_factor=None):
    """Fold device-resident partials (``(h1, h2, v, ok)`` tuples from
    :func:`mesh_keyed_fold` with ``raw=True``, or a device ref's lanes)
    into one over ``mesh``, on the device: the concatenated lanes enter
    the program sharded in order.  Lane safety is the caller's: it bounds
    the absolute sum over everything it folded, and every part has one
    value dtype."""
    dev = mesh.devices[0]
    h1 = torch.cat([p[0].to(dev) for p in parts])
    h2 = torch.cat([p[1].to(dev) for p in parts])
    v = torch.cat([p[2].to(dev) for p in parts])
    ok = torch.cat([p[3].to(dev) for p in parts])
    D = _mesh.mesh_size(mesh)
    if D == 1:
        n_pad = _pad_pow2(h1.shape[0])
        if n_pad != h1.shape[0]:
            h1, h2, v, ok = _padded((h1, h2, v, ok), n_pad)
        return _one_shard_fold((ok != 1).to(torch.int32), h1, h2, v, kind,
                               nonneg)
    n_local = _pad_pow2(-(-h1.shape[0] // D))
    if n_local * D != h1.shape[0]:
        h1, h2, v, ok = _padded((h1, h2, v, ok), n_local * D)
    return _run_fold_padded(
        mesh, h1, h2, v, ok, n_local, kind, nonneg,
        capacity_factor or settings.shuffle_capacity_factor)


def _live_prefix_sort(h1, h2, v, ok):
    """The lanes stably sorted with the live rows first."""
    _, order = torch.sort((ok != 1).to(torch.int32), stable=True)
    return h1[order], h2[order], v[order]


def compact_partial(part):
    """Shrink a device partial to a power-of-two pad of its live rows.
    A refold's output is as long as its input (D * C rows on a mesh),
    dead rows included, so partials folded again and again would carry
    ever more dead rows; one validity sort and a slice bound each at its
    distinct keys.  One scalar fetch (the live count)."""
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


def mesh_global_sum(mesh, v):
    """A global aggregate over the mesh: each shard's sum, then the psum
    (the degenerate-key case: ``len`` and global sums).  Integers sum in
    int64, float32 in float32."""
    v = _lane_safe_values(np.asarray(v), "sum")
    D = _mesh.mesh_size(mesh)
    total = len(v)
    n_local = max(1, -(-total // D))
    pv = np.zeros(n_local * D, dtype=v.dtype)
    pv[:total] = v
    with _trace.span("collective", "global-sum", records=int(total)):
        parts = _mesh.shard(mesh, torch.from_numpy(pv))
        out = _mesh.psum(mesh, [p.sum() for p in parts])[0]
    return out.item()
