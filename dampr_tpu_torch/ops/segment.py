"""Sort-based grouping and segment reduction.

Port of ``dampr_tpu/ops/segment.py``.  Records group by lexsorting their
dual hash lanes, segment boundaries come from adjacent-hash inequality,
numeric values fold per segment, and same-hash neighbours are verified to
hold equal real keys (a 64-bit collision regroups exactly on host).

The reference's device branch is XLA (``_lexsort_jit``,
``_segment_fold_jit``); here it is plain torch on ``settings.device``: a
stable ``torch.sort`` over an order-preserving int64 packing of the
unsigned lanes, and ``index_add_``/``scatter_reduce`` per segment.
"""


import numpy as np

from .. import settings
from . import devtime

# ---------------------------------------------------------------------------
# Associative fold descriptors
# ---------------------------------------------------------------------------


class AssocOp(object):
    """An associative binop.  ``kind`` is a device-foldable tag
    ('sum'|'min'|'max'|'first') or None for an opaque Python binop; ``fn``
    is the Python binop.  ``elementwise`` marks ops whose ``fn`` is
    elementwise over tuple values, so 2D composite lanes may fold
    vectorized (a plain ``min`` over tuples is lexicographic, not
    elementwise, and stays on the ``fn`` path)."""

    __slots__ = ("kind", "fn", "elementwise")

    def __init__(self, kind, fn, elementwise=False):
        self.kind = kind
        self.fn = fn
        self.elementwise = elementwise

    def __call__(self, a, b):
        return self.fn(a, b)


SUM = AssocOp("sum", lambda a, b: a + b)
MIN = AssocOp("min", lambda a, b: a if a <= b else b)
MAX = AssocOp("max", lambda a, b: a if a >= b else b)
FIRST = AssocOp("first", lambda a, _b: a)
#: Elementwise pair sum: composite (sum, count) accumulators (``mean()``).
#: The "sum" kind folds 2D lanes vectorized; the fn gives object-lane
#: tuples an exact pairwise fold (plain SUM.fn would concatenate them).
PAIR_SUM = AssocOp("sum", lambda a, b: (a[0] + b[0], a[1] + b[1]),
                   elementwise=True)


def as_assoc_op(binop):
    """Wrap a Python binop; operator.add, min and max get a device kind."""
    import operator

    if isinstance(binop, AssocOp):
        return binop
    known = {operator.add: SUM, operator.iadd: SUM, min: MIN, max: MAX}
    return known.get(binop) or AssocOp(None, binop)


# ---------------------------------------------------------------------------
# Hash lexsort
# ---------------------------------------------------------------------------


def packed_lane_key(h1, h2):
    """One int64 sort key per record whose signed order equals the
    unsigned lexicographic order of (h1, h2): ``(h1 - 2^31) * 2^32 + h2``
    for int64 tensors holding uint32 values — in range, no overflow."""
    return (h1 - (1 << 31)) * (1 << 32) + h2


def hash_sort_perm(h1, h2):
    """The stable permutation sorting records by (h1, h2)."""
    n = len(h1)
    if settings.use_device_for(n):
        import torch

        dev = settings.resolve_device()
        with devtime.keyed_call("hash_sort") as t:
            key = packed_lane_key(
                torch.from_numpy(h1.astype(np.int64)).to(dev),
                torch.from_numpy(h2.astype(np.int64)).to(dev))
            _, perm = torch.sort(key, stable=True)
            out = perm.to(torch.int32).cpu().numpy()
        devtime.keyed("hash_sort", t.seconds, 16 * n, 4 * n, t.cpu)
        return out
    return np.lexsort((h2, h1)).astype(np.int32)


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------


def _adjacent_new_segment(h1s, h2s):
    """Boolean[n]: True where a new (h1, h2) segment starts."""
    n = len(h1s)
    starts = np.empty(n, dtype=bool)
    if n == 0:
        return starts
    starts[0] = True
    np.not_equal(h1s[1:], h1s[:-1], out=starts[1:])
    starts[1:] |= h2s[1:] != h2s[:-1]
    return starts


def _keys_adjacent_equal(keys_sorted):
    """Boolean[n-1]: keys_sorted[i] == keys_sorted[i+1]."""
    if keys_sorted.dtype != object:
        return keys_sorted[1:] == keys_sorted[:-1]
    a = keys_sorted[:-1]
    b = keys_sorted[1:]
    return np.fromiter((a[i] == b[i] for i in range(len(a))), dtype=bool,
                       count=len(a))


class SortedGroups(object):
    """A hash-sorted block with verified exact group starts."""

    __slots__ = ("block", "starts")

    def __init__(self, block, starts):
        self.block = block
        self.starts = starts

    @property
    def n_groups(self):
        return len(self.starts)

    def bounds(self):
        ends = np.empty_like(self.starts)
        ends[:-1] = self.starts[1:]
        if len(ends):
            ends[-1] = len(self.block)
        return self.starts, ends


def sort_and_group(block):
    """Sort a Block by hash and return exact SortedGroups."""
    if len(block) == 0:
        return SortedGroups(block, np.empty(0, dtype=np.int64))
    h1, h2 = block.hashes()
    sb = block.take(hash_sort_perm(h1, h2))
    starts_mask = _adjacent_new_segment(sb.h1, sb.h2)
    same_hash = ~starts_mask[1:]
    if same_hash.any():
        bad = same_hash & ~_keys_adjacent_equal(sb.keys)
        if bad.any():
            starts_mask[1:] |= bad
            starts_mask = _repair_collisions(sb, starts_mask)
    return SortedGroups(sb, np.flatnonzero(starts_mask))


def _repair_collisions(sb, starts_mask):
    """Exact regroup of hash-runs holding more than one distinct key:
    reorder each such run so equal keys are contiguous (first-appearance
    order), in place, and return the rebuilt starts mask."""
    run_starts = np.flatnonzero(_adjacent_new_segment(sb.h1, sb.h2))
    run_ends = np.append(run_starts[1:], len(sb))
    perm = np.arange(len(sb))
    new_mask = starts_mask.copy()
    for s, e in zip(run_starts, run_ends):
        if e - s <= 1:
            continue
        distinct = []  # [(key, [local indices])] in first-appearance order
        for i, kk in enumerate(sb.keys[s:e]):
            for dk, idxs in distinct:
                if dk == kk:
                    idxs.append(i)
                    break
            else:
                distinct.append((kk, [i]))
        if len(distinct) > 1:
            order = []
            new_mask[s:e] = False
            for _dk, idxs in distinct:
                new_mask[s + len(order)] = True
                order.extend(idxs)
            perm[s:e] = s + np.asarray(order)
    sb.keys = sb.keys.take(perm)
    sb.values = sb.values[perm]
    sb.h1 = sb.h1.take(perm)
    sb.h2 = sb.h2.take(perm)
    return new_mask


# ---------------------------------------------------------------------------
# Segment folds
# ---------------------------------------------------------------------------

_NP_FOLD = {
    "sum": np.add,
    "min": np.minimum,
    "max": np.maximum,
}

_I64_MAX = 2 ** 63 - 1


def _device_fold_exact(vals, kind):
    """True when folding ``vals`` on the device gives exactly the host
    fold's values.

    The reference keys this on ``jax_enable_x64`` because its device lanes
    are 32-bit.  torch has native 64-bit integer lanes, so integer (and
    bool-promoted) lanes always fold exactly on the device: an int64 sum
    wraps modulo 2^64 just as the host's int64 ``reduceat`` does, and
    min/max never overflow.  What stays host: object lanes, unsigned lanes
    (torch's uint16/32/64 support is partial; unsigned sums arrive here
    already widened to int64) and floats — a float sum's value depends on
    its order, and the device scatter has no fixed order."""
    return vals.dtype.kind == "i"


def _device_fold(vals, starts, ends, kind):
    """Segment fold of an integer lane on the device -> numpy array."""
    import torch

    dev = settings.resolve_device()
    ng = len(starts)
    with devtime.keyed_call("segment_fold") as t:
        seg = torch.repeat_interleave(
            torch.arange(ng, device=dev),
            torch.from_numpy((ends - starts).astype(np.int64)).to(dev))
        vals = np.ascontiguousarray(vals)
        v = torch.from_numpy(vals).to(dev)
        out = torch.zeros((ng,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=dev)
        if kind == "sum":
            out.index_add_(0, seg, v)
        else:
            if v.dim() == 2:
                seg = seg[:, None].expand_as(v)
            out.scatter_reduce_(0, seg, v, reduce="amin" if kind == "min"
                                else "amax", include_self=False)
        folded = out.cpu().numpy()
    devtime.keyed("segment_fold", t.seconds, vals.nbytes + 8 * ng,
                  folded.nbytes, t.cpu)
    return folded


def fold_sorted(groups, op):
    """Fold each group's values with ``op`` -> compacted Block (one record
    per group, hashes preserved): ``first`` gathers each group's first
    record; device segment folds when ``op.kind`` is sum/min/max and the
    lane qualifies (1D, or 2D under an elementwise op); host otherwise."""
    from ..blocks import Block, _column_from_list, pylist

    sb = groups.block
    starts, ends = groups.bounds()
    n = len(sb)
    ng = groups.n_groups
    if ng == 0:
        return Block.empty()

    kh1 = sb.h1.take(starts)
    kh2 = sb.h2.take(starts)
    keys = sb.keys.take(starts)

    if op.kind == "first":
        # The stable sort keeps arrival order within a group, so its first
        # record sits at its start: a gather, any dtype.
        return Block(keys, sb.values[starts], kh1, kh2)

    # 2D composite lanes fold vectorized only under an elementwise op
    # (PAIR_SUM); a generic add/min/max over tuples concatenates or
    # compares lexicographically and takes the fn path below.
    if (op.kind in _NP_FOLD and sb.numeric_values
            and (sb.values.ndim == 1 or op.elementwise)):
        vals = sb.values
        if vals.dtype == np.bool_:
            vals = vals.astype(np.int64)  # Python semantics: True + True == 2
        elif vals.dtype == np.uint64 and op.kind == "sum":
            if not len(vals) or len(vals) * int(vals.max()) <= _I64_MAX:
                vals = vals.astype(np.int64)
            else:
                ov = np.empty(len(vals), dtype=object)
                ov[:] = [int(x) for x in vals]
                vals = ov
        elif (op.kind == "sum" and vals.dtype.kind in "iu"
                and vals.dtype.itemsize < 8):
            vals = vals.astype(np.int64)  # narrow int sums would wrap
        if settings.use_device_for(n) and _device_fold_exact(vals, op.kind):
            # segment ids from the collision-repaired group bounds; a 2D
            # lane folds its rows with one index_add_
            folded = _device_fold(vals, starts, ends, op.kind)
        else:
            folded = _NP_FOLD[op.kind].reduceat(vals, starts)
        return Block(keys, folded, kh1, kh2)

    # Host generic fold over boxed values, converted a bounded window at a
    # time: a run of whole groups fitting one window boxes once, and one
    # oversized group folds across windows carrying its accumulator.
    W = 65536
    fn = op.fn
    out_vals = [None] * ng
    varr = sb.values
    gi = 0
    while gi < ng:
        s0, e0 = int(starts[gi]), int(ends[gi])
        if e0 - s0 > W:
            acc, first = None, True
            for w0 in range(s0, e0, W):
                it = iter(pylist(varr[w0:min(e0, w0 + W)]))
                if first:
                    acc, first = next(it), False
                for v in it:
                    acc = fn(acc, v)
            out_vals[gi] = acc
            gi += 1
            continue
        ge = gi + 1
        while ge < ng and int(ends[ge]) - s0 <= W:
            ge += 1
        win = pylist(varr[s0:int(ends[ge - 1])])
        ls = (starts[gi:ge] - s0).tolist()
        le = (ends[gi:ge] - s0).tolist()
        for i in range(ge - gi):
            acc = win[ls[i]]
            for j in range(ls[i] + 1, le[i]):
                acc = fn(acc, win[j])
            out_vals[gi + i] = acc
        gi = ge
    return Block(keys, _column_from_list(out_vals), kh1, kh2)


def fold_block(block, op):
    """sort_and_group + fold_sorted (map-side combine compaction)."""
    return fold_sorted(sort_and_group(block), op)
