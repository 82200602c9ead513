"""The ``cached()`` tier of dampr_tpu_torch against dampr_tpu's.

The port version of ``tests/test_cached_tier.py``: pinned blocks live
gzip-compressed in RAM (``storage.pack_block``), are charged at their
compressed size, never spill, and pinned blocks that alone exceed the
budget raise ``MemoryError`` in both packages.  The packed bytes are the
JAX package's format: each package unpacks the other's.  A persisted
pinned ref (a checkpoint of a ``cached()`` stage) is that same stream on
disk, and both packages' block readers load it.  Inputs are made from a
seed with numpy; every comparison is exact.
"""

import operator

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import storage as ref_storage
from dampr_tpu_torch import settings
from dampr_tpu_torch import storage
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.storage import RunStore


@pytest.fixture(autouse=True)
def cpu(tmp_path):
    old = (settings.device, settings.scratch_root)
    settings.device = "cpu"
    settings.scratch_root = str(tmp_path / "scratch")
    yield
    settings.device, settings.scratch_root = old


def _big_block(n=20000):
    keys = np.arange(n, dtype=np.int64)
    vals = np.zeros(n, dtype=np.int64)  # compresses well
    return Block(keys, vals)


class TestCompressedPinned:
    def test_pinned_ref_is_compressed_and_round_trips(self):
        store = RunStore("cached-tier", budget=1 << 30)
        blk = _big_block()
        ref = store.register(blk, pin=True)
        assert ref.nbytes < blk.nbytes() // 4  # compressed charge
        got = ref.get()
        np.testing.assert_array_equal(got.keys, blk.keys)
        np.testing.assert_array_equal(got.values, blk.values)
        # windows stream from the packed copy too
        n = sum(len(w) for w in ref.iter_windows())
        assert n == len(blk)
        # the JAX package's tier holds the same block as compactly
        ref_store = ref_storage.RunStore("cached-tier-ref", budget=1 << 30)
        jref = ref_store.register(
            dampr_tpu.blocks.Block(blk.keys, blk.values), pin=True)
        assert jref.nbytes < blk.nbytes() // 4

    def test_pinned_never_spills(self):
        # the budget holds the (tiny, compressed) pinned block, nothing else
        store = RunStore("cached-nospill", budget=8192)
        ref = store.register(Block.from_lists([1] * 100, [2] * 100),
                             pin=True)
        unpinned = store.register(_big_block(), pin=False)
        store.drain_writes()  # spill writes are asynchronous
        assert not unpinned.resident  # spilled to meet the budget
        assert ref.path is None  # pinned stayed in (compressed) RAM
        assert ref.get().to_lists() == ([1] * 100, [2] * 100)

    def test_over_budget_pinning_raises(self):
        store = RunStore("cached-hardfail", budget=1024)
        rng = np.random.RandomState(0)
        incompressible = Block(
            np.arange(50000, dtype=np.int64),
            rng.randint(-2 ** 62, 2 ** 62, size=50000))
        with pytest.raises(MemoryError, match="cached"):
            store.register(incompressible, pin=True)
        ref_store = ref_storage.RunStore("cached-hardfail-ref", budget=1024)
        with pytest.raises(MemoryError, match="cached"):
            ref_store.register(dampr_tpu.blocks.Block(
                incompressible.keys, incompressible.values), pin=True)

    def test_cached_pipeline_still_exact(self):
        data = list(range(500))

        def build(pkg):
            return pkg.Dampr.memory(data, partitions=4).map(
                lambda x: x * 2).cached()

        out = sorted(build(dampr_tpu_torch).run().read())
        assert out == [x * 2 for x in data]
        assert out == sorted(build(dampr_tpu).run().read())


class TestFormat:
    @pytest.mark.parametrize("kind", ["int", "object"])
    def test_packed_bytes_cross_read(self, kind):
        rng = np.random.RandomState(3)
        keys = rng.randint(0, 1 << 40, size=3000).astype(np.int64)
        if kind == "int":
            vals = rng.randint(0, 100, size=3000).astype(np.int64)
        else:
            vals = np.empty(3000, dtype=object)
            vals[:] = ["v{}".format(int(x)) for x in keys % 97]
        blk = Block(keys, vals)
        port = storage.unpack_block(storage.pack_block(blk))
        jax_side = ref_storage.unpack_block(storage.pack_block(blk))
        back = storage.unpack_block(ref_storage.pack_block(
            dampr_tpu.blocks.Block(keys, vals)))
        for got in (port, jax_side, back):
            np.testing.assert_array_equal(got.keys, keys)
            assert list(got.values) == list(vals)

    def test_legacy_stream_loads_in_both(self, tmp_path):
        """A persisted pinned ref is a gzip'd pickle window on disk (the
        pre-frame spill format): both packages' block readers load it."""
        rng = np.random.RandomState(5)
        keys = rng.randint(0, 1000, size=5000).astype(np.int64)
        blk = Block(keys, keys * 3)
        p = str(tmp_path / "pinned.blk")
        with open(p, "wb") as f:
            f.write(storage.pack_block(blk))
        for load in (storage.load_block, ref_storage.load_block):
            got = load(p)
            np.testing.assert_array_equal(got.keys, keys)
            np.testing.assert_array_equal(got.values, keys * 3)


class TestBudgetDifference:
    """The re-anchor's one difference in records: over a budget the
    compressed ``cached()`` blocks alone exceed, the JAX package raised
    ``MemoryError`` where the port returned records.  Both raise now, and
    both return the same records under a budget that holds them."""

    def _build(self, pkg):
        rng = np.random.RandomState(11)
        data = rng.randint(-2 ** 62, 2 ** 62, size=20000).tolist()
        return (pkg.Dampr.memory(data, partitions=4)
                .map(lambda x: (x % 1000, x)).cached()
                .fold_by(lambda kv: kv[0], operator.add, lambda kv: 1))

    def test_both_raise_over_budget(self):
        with pytest.raises(MemoryError, match="cached"):
            self._build(dampr_tpu_torch).run(memory_budget=16 * 1024)
        with pytest.raises(MemoryError, match="cached"):
            self._build(dampr_tpu).run(memory_budget=16 * 1024)

    def test_equal_records_within_budget(self):
        got = self._build(dampr_tpu_torch).run(
            memory_budget=64 << 20).read()
        want = self._build(dampr_tpu).run(memory_budget=64 << 20).read()
        assert got == want
        assert sum(v for _k, v in got) == 20000
