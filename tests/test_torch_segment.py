"""dampr_tpu_torch grouping and segment folds against the JAX package.

The same blocks (numpy lanes carried across with ``interop``) go through
``dampr_tpu.ops.segment`` and the port's ``ops.segment``: group order and
folded values must be equal, on the host path and on the device branch
(torch on the CPU device above the dispatch threshold), including forced
64-bit collisions.  Tolerance: exact (float sums stay on host in both).
"""

import operator

import numpy as np
import pytest

from dampr_tpu import blocks as ref_blocks
from dampr_tpu.ops import segment as ref_segment
from dampr_tpu_torch import interop
from dampr_tpu_torch import settings as port_settings
from dampr_tpu_torch.blocks import pylist
from dampr_tpu_torch.ops import segment as port_segment


@pytest.fixture(autouse=True)
def cpu_device():
    old = port_settings.device
    port_settings.device = "cpu"
    yield
    port_settings.device = old


def _values(kind, n, rng):
    if kind == "int":
        return rng.randint(-10 ** 6, 10 ** 6, size=n).astype(np.int64)
    if kind == "big_int":
        return rng.randint(-2 ** 40, 2 ** 40, size=n).astype(np.int64)
    if kind == "int32":
        return rng.randint(0, 2 ** 31 - 1, size=n).astype(np.int32)
    if kind == "bool":
        return rng.rand(n) < 0.5
    if kind == "float":
        return rng.rand(n) * 100
    if kind == "pairs":
        return rng.randint(0, 100, size=(n, 2)).astype(np.int64)
    if kind == "object":
        out = np.empty(n, dtype=object)
        out[:] = ["v%d" % x for x in rng.randint(0, 50, size=n)]
        return out
    raise ValueError(kind)


def _block(kind, n, seed, n_keys=300):
    rng = np.random.RandomState(seed)
    keys = np.empty(n, dtype=object)
    keys[:] = ["k%d" % x for x in rng.randint(0, n_keys, size=n)]
    return keys, _values(kind, n, rng)


def _as_records(blk):
    return list(zip(pylist(blk.keys), pylist(blk.values),
                    blk.h1.tolist(), blk.h2.tolist()))


OPS = {"sum": (ref_segment.SUM, port_segment.SUM),
       "min": (ref_segment.MIN, port_segment.MIN),
       "max": (ref_segment.MAX, port_segment.MAX),
       "opaque": (ref_segment.as_assoc_op(lambda a, b: a + b),
                  port_segment.as_assoc_op(lambda a, b: a + b))}

COMBOS = [("int", "sum"), ("int", "min"), ("int", "max"), ("big_int", "sum"),
          ("int32", "sum"), ("bool", "sum"), ("float", "sum"),
          ("float", "max"), ("pairs", "sum"), ("object", "sum"),
          ("object", "min"), ("int", "opaque")]


class TestFoldParity:
    @pytest.mark.parametrize("n", [500, 6000])
    @pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(c))
    def test_fold_block_matches_reference(self, combo, n):
        """n=6000 takes both packages' device branches (threshold 4096)."""
        kind, opname = combo
        keys, vals = _block(kind, n, seed=n)
        ref_op, port_op = OPS[opname]
        want = ref_segment.fold_block(ref_blocks.Block(keys, vals), ref_op)
        got = port_segment.fold_block(
            interop.block_from_arrays(keys, vals), port_op)
        assert _as_records(got) == _as_records(want)

    def test_as_assoc_op_kinds_match(self):
        for fn in (operator.add, operator.iadd, min, max, lambda a, b: a):
            assert (port_segment.as_assoc_op(fn).kind
                    == ref_segment.as_assoc_op(fn).kind)

    @pytest.mark.parametrize("n", [200, 6000])
    def test_hash_sort_perm_matches(self, n):
        rng = np.random.RandomState(n)
        h1 = rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(
            np.uint32)
        h1[::5] = h1[0]  # ties, broken by arrival order
        h2 = rng.randint(0, 1 << 32, size=n, dtype=np.uint64).astype(
            np.uint32)
        np.testing.assert_array_equal(port_segment.hash_sort_perm(h1, h2),
                                      ref_segment.hash_sort_perm(h1, h2))


class TestCollisionRepair:
    def test_forced_collisions_group_exactly_like_reference(self):
        """Distinct keys forced onto one (h1, h2) regroup by real key, in
        the reference's order."""
        rng = np.random.RandomState(4)
        n = 400
        ids = rng.randint(0, 6, size=n)
        keys = np.empty(n, dtype=object)
        keys[:] = ["c%d" % x for x in ids]
        vals = rng.randint(0, 9, size=n).astype(np.int64)
        # c0-c2 share one 64-bit hash, c3-c5 another
        h1 = np.where(ids < 3, 7, 9).astype(np.uint32)
        h2 = np.full(n, 5, dtype=np.uint32)
        want = ref_segment.fold_block(
            ref_blocks.Block(keys, vals, h1.copy(), h2.copy()),
            ref_segment.SUM)
        got = port_segment.fold_block(
            interop.block_from_arrays(keys, vals, h1, h2), port_segment.SUM)
        assert _as_records(got) == _as_records(want)
        assert len(set(pylist(got.keys))) == len(got)


class TestBlocksParity:
    def test_split_by_partition_matches(self):
        keys, vals = _block("int", 3000, seed=9)
        want = ref_blocks.Block(keys, vals).split_by_partition(17)
        got = interop.block_from_arrays(keys, vals).split_by_partition(17)
        assert sorted(got) == sorted(want)
        for pid in want:
            assert _as_records(got[pid]) == _as_records(want[pid])

    def test_merge_sorted_streams_matches(self):
        rng = np.random.RandomState(5)

        def runs(pkg_block):
            out = []
            for r in range(4):
                k = np.sort(rng.randint(0, 50, size=200)).astype(np.int64)
                out.append([pkg_block(k[i:i + 37], k[i:i + 37] * 10)
                            for i in range(0, 200, 37)])
            return out

        state = rng.get_state()
        want = list(ref_blocks.merge_sorted_streams(runs(ref_blocks.Block)))
        rng.set_state(state)
        from dampr_tpu_torch import blocks as port_blocks

        got = list(port_blocks.merge_sorted_streams(runs(port_blocks.Block)))
        flat = (lambda bs: [(k, v) for b in bs
                            for k, v in zip(b.keys.tolist(),
                                            b.values.tolist())])
        assert flat(got) == flat(want)
