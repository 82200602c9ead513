"""The HBM tier of dampr_tpu_torch against dampr_tpu's.

The port versions of ``tests/test_hbm_tier.py`` (less
``test_resume_persists_device_refs``: resume is a later slice).  Integer
value lanes of map outputs a device fold reads stay on the device between
map and reduce; device -> host offload is the first spill step, disk the
second.  The port's device is the CPU here (the tier's mechanics, its
budgets, offload cascade and accounting, do not depend on it), the JAX
package's its 8-device CPU rig.  Pipelines are held against the JAX
package's records and a Python oracle; every comparison is exact.
"""

import operator

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import settings as ref_settings
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import settings, storage
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.runner import MTRunner
from dampr_tpu_torch.storage import RunStore

_REF = ("partitions", "mesh_fold", "hbm_budget", "hbm_min_records")


@pytest.fixture(autouse=True)
def hbm_enabled(monkeypatch):
    old = (settings.partitions, settings.hbm_budget, settings.device)
    old_ref = {n: getattr(ref_settings, n) for n in _REF}
    settings.partitions = ref_settings.partitions = 8
    settings.device = "cpu"
    ref_settings.mesh_fold = "auto"
    settings.hbm_budget = ref_settings.hbm_budget = 64 * 1024 * 1024
    ref_settings.hbm_min_records = 1
    monkeypatch.setattr(storage, "HBM_MIN_RECORDS", 1)
    yield
    settings.partitions, settings.hbm_budget, settings.device = old
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)


def _mkblock(n, key_mod=17, scale=1):
    ks = np.arange(n, dtype=np.int64) % key_mod
    vs = (np.arange(n, dtype=np.int64) % 100) * scale
    return Block(ks, vs)


def _run(pkg, runner_cls, build, name):
    """(the output as a dict, the runner) of ``build(pkg)`` through the
    package's runner directly, as the JAX suite drives it."""
    pipe = build(pkg)
    runner = runner_cls(name, pipe.pmer.graph)
    out = runner.run([pipe.source])
    return dict(v for _k, v in out[0].read()), runner


def _count13(pkg):
    return (pkg.Dampr.memory(list(range(20000)), partitions=8)
            .count(lambda x: x % 13))


class TestDeviceRefs:
    def test_roundtrip_exact(self):
        store = RunStore("hbm-rt")
        blk = _mkblock(8192)
        ref = store.register(blk, device=True)
        assert ref.is_device
        got = ref.get()
        assert np.array_equal(got.keys, blk.keys)
        assert np.array_equal(got.values, blk.values)
        assert got.values.dtype == blk.values.dtype
        assert store.d2h_bytes == 8 * 8192  # the read was a counted fetch
        store.cleanup()

    @pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.bool_])
    def test_roundtrip_keeps_the_value_dtype(self, dtype):
        """Integer and bool lanes ride the device as int64 and come back
        in their own dtype."""
        store = RunStore("hbm-rt-dtype")
        blk = Block(np.arange(5000, dtype=np.int64),
                    (np.arange(5000) % 3).astype(dtype))
        ref = store.register(blk, device=True)
        assert ref.is_device
        got = ref.get()
        assert got.values.dtype == np.dtype(dtype)
        assert np.array_equal(got.values, blk.values)
        store.cleanup()

    def test_host_budget_charges_metadata_only(self):
        store = RunStore("hbm-meta")
        blk = _mkblock(8192)
        ref = store.register(blk, device=True)
        # the host holds keys and two uint32 hash lanes; the value lane and
        # the hash lanes' device copies are device bytes
        h1, _ = blk.hashes()
        assert ref.nbytes == blk.keys.nbytes + 2 * h1.nbytes
        assert ref.dev_bytes == 8192 * 16
        assert ref.total_bytes == ref.nbytes + ref.dev_bytes
        store.cleanup()

    @pytest.mark.parametrize("values", ["object", "float"])
    def test_object_and_float_values_stay_host(self, values):
        """Object lanes have no device tier; float lanes fold on the host
        in the port (a device sum has no fixed order)."""
        store = RunStore("hbm-obj")
        if values == "object":
            vs = np.empty(100, dtype=object)
            vs[:] = [("t", i) for i in range(100)]
        else:
            vs = np.arange(100, dtype=np.float64) / 3
        ref = store.register(Block(np.arange(100, dtype=np.int64), vs),
                             device=True)
        assert not ref.is_device
        store.cleanup()

    def test_offload_cascade_below_working_set(self):
        """An HBM budget below the working set offloads the oldest device
        refs to the host; a host budget below that cascades to disk.  The
        data stays exact."""
        settings.hbm_budget = 1 << 16  # 64 KB: far below the working set
        store = RunStore("hbm-cascade", budget=1 << 17)
        blocks = [_mkblock(8192, key_mod=50 + i) for i in range(8)]
        refs = [store.register(b, device=True) for b in blocks]
        store.drain_writes()
        assert store.hbm_offloads > 0, "nothing offloaded"
        assert store.spill_count > 0, "host pressure never hit disk"
        assert store._dev_bytes <= 1 << 16
        for b, r in zip(blocks, refs):
            got = r.get()
            assert np.array_equal(got.keys, b.keys)
            assert np.array_equal(got.values, b.values)
        store.cleanup()

    def test_release_device_drops_every_device_ref(self):
        store = RunStore("hbm-release")
        refs = [store.register(_mkblock(4096, key_mod=7 + i), device=True)
                for i in range(3)]
        assert store._dev_bytes == 3 * 4096 * 16
        store.release_device()
        assert store._dev_bytes == 0 and not store._dev_resident
        assert all(r._dead and not r.is_device for r in refs)
        assert store._resident_bytes == 0
        store.cleanup()


class TestBoundaryZeroCopy:
    def test_fold_consumes_device_refs_without_host_copy(self):
        """map -> count fold: the reduce reads the map outputs' lanes on
        the device.  The only device -> host bytes are the fold's one
        fetch of its result (16 bytes a key), never the map's blocks."""
        want = {i: len(range(i, 20000, 13)) for i in range(13)}
        ref, _ = _run(dampr_tpu, RefRunner, _count13, "hbm-boundary")
        got, runner = _run(dampr_tpu_torch, MTRunner, _count13,
                           "hbm-boundary")
        assert got == ref == want
        sto = runner.store
        assert sto.h2d_bytes > 0, "nothing rode the HBM tier"
        assert runner.mesh_folds >= 1, "the fold did not run on the device"
        assert sto.d2h_bytes == 16 * 13, (
            "the map->reduce boundary copied %d bytes through the host"
            % sto.d2h_bytes)

    def test_sum_fold_exact_through_hbm(self):
        def build(pkg):
            return (pkg.Dampr.memory(list(range(30000)), partitions=8)
                    .a_group_by(lambda x: x % 9).sum())

        want = {k: sum(range(k, 30000, 9)) for k in range(9)}
        ref, _ = _run(dampr_tpu, RefRunner, build, "hbm-sum")
        got, runner = _run(dampr_tpu_torch, MTRunner, build, "hbm-sum")
        assert got == ref == want
        assert runner.store.h2d_bytes > 0
        assert runner.mesh_folds >= 1

    @pytest.mark.parametrize("kind", ["min", "max"])
    def test_min_max_fold_exact_through_hbm(self, kind):
        def build(pkg):
            return (pkg.Dampr.memory(list(range(-5000, 15000)), partitions=8)
                    .a_group_by(lambda x: x % 11)
                    .reduce(min if kind == "min" else max))

        ref, _ = _run(dampr_tpu, RefRunner, build, "hbm-" + kind)
        got, runner = _run(dampr_tpu_torch, MTRunner, build, "hbm-" + kind)
        assert got == ref
        assert runner.mesh_folds >= 1

    def test_host_fallback_still_exact_when_tier_disabled(self):
        settings.hbm_budget = ref_settings.hbm_budget = 0
        want = {i: len(range(i, 20000, 13)) for i in range(13)}
        ref, _ = _run(dampr_tpu, RefRunner, _count13, "hbm-off")
        got, runner = _run(dampr_tpu_torch, MTRunner, _count13, "hbm-off")
        assert got == ref == want
        assert runner.store.h2d_bytes == 0
        assert runner.mesh_folds == 0


class TestLaneSafety:
    def test_large_values_ride_int64_lanes(self):
        """Values past int32 stay exact: the port's lanes are int64 (the
        JAX package keeps them on the host without x64)."""
        store = RunStore("hbm-lane")
        big = Block(np.arange(8192, dtype=np.int64),
                    np.full(8192, 2 ** 40, dtype=np.int64))
        ref = store.register(big, device=True)
        assert ref.is_device
        assert np.array_equal(ref.get().values, big.values)
        store.cleanup()

    def test_uint64_values_stay_host(self):
        store = RunStore("hbm-u64")
        ref = store.register(Block(np.arange(100, dtype=np.int64),
                                   np.full(100, 2 ** 63, dtype=np.uint64)),
                             device=True)
        assert not ref.is_device
        store.cleanup()

    def test_huge_sum_pipeline_exact(self):
        """Values whose sum overflows int32: the exact total whichever
        tier and path the run takes, equal to the JAX package's."""
        n = 9000

        def build(pkg):
            return (pkg.Dampr.memory([2 ** 30 + i for i in range(n)],
                                     partitions=8)
                    .a_group_by(lambda x: 0).sum())

        ref, _ = _run(dampr_tpu, RefRunner, build, "hbm-huge")
        got, _ = _run(dampr_tpu_torch, MTRunner, build, "hbm-huge")
        assert got == ref == {0: sum(2 ** 30 + i for i in range(n))}

    def test_sum_past_int64_takes_the_host_path(self):
        """A running absolute sum past int64 would wrap on the device: the
        fold takes the host path, whose Python ints are exact."""
        def build(pkg):
            return (pkg.Dampr.memory([2 ** 62] * 8 + [1, 2, 3], partitions=8)
                    .a_group_by(lambda x: x % 2).sum())

        got, runner = _run(dampr_tpu_torch, MTRunner, build, "hbm-i64")
        ref, _ = _run(dampr_tpu, RefRunner, build, "hbm-i64")
        assert got == ref
        assert runner.mesh_folds == 0


class TestDeviceFoldWindows:
    """``_mesh_reduce`` over one device ref and one host ref, so the host
    ref's window takes ``flush``: the only way it gives way to the host
    path is a value lane the device fold cannot hold exactly."""

    @staticmethod
    def _reduce(host_values, op=operator.add):
        import types

        from dampr_tpu_torch import base

        runner = MTRunner("hbm-flush", dampr_tpu_torch.Dampr.memory([1])
                          .a_group_by(lambda x: x).sum().pmer.graph)
        pset = storage.PartitionSet(8)
        dev_ref = runner.store.register(_mkblock(4096), device=True)
        assert dev_ref.is_device
        host_keys = np.arange(len(host_values), dtype=np.int64) + 1000
        pset.add(0, dev_ref)
        pset.add(1, runner.store.register(Block(host_keys, host_values)))
        stage = types.SimpleNamespace(
            reducer=base.AssocFoldReducer(op), options={})
        try:
            return runner._mesh_reduce(stage, [pset]), runner
        finally:
            runner.store.cleanup()

    def test_host_window_folds_on_the_device(self):
        out, runner = self._reduce(np.arange(10, dtype=np.uint64))
        assert out is not None and out[1] == 17 + 10
        assert runner.mesh_folds == 1

    def test_uint64_past_int64_in_a_host_window_takes_the_host_path(self):
        out, runner = self._reduce(
            np.full(10, 2 ** 63 + 5, dtype=np.uint64), op=max)
        assert out is None and runner.mesh_folds == 0

    def test_a_refused_launch_raises_and_never_takes_the_host_path(
            self, monkeypatch):
        """A kernel wrapper's ValueError once the lanes are on the device
        is a failure of the run, not a reason for the host fold."""
        from dampr_tpu_torch.parallel import shuffle

        def refuse(*a, **kw):
            raise ValueError("segfold refused the lanes (injected)")

        monkeypatch.setattr(shuffle, "mesh_keyed_fold", refuse)
        with pytest.raises(ValueError, match="injected"):
            self._reduce(np.arange(10, dtype=np.int64))


class TestIntersections:
    def test_host_pressure_evicts_device_metadata(self):
        """Device refs' host keys and hash lanes are evictable under host
        pressure (offload, then disk), never a MemoryError."""
        settings.hbm_budget = 1 << 30  # roomy device, tiny host budget
        store = RunStore("hbm-hostpressure", budget=1 << 14)
        blocks = [_mkblock(4096, key_mod=97 + i) for i in range(10)]
        refs = [store.register(b, device=True) for b in blocks]
        store.drain_writes()
        assert store.spill_count > 0
        assert store.hbm_offloads > 0
        for b, r in zip(blocks, refs):
            got = r.get()
            assert np.array_equal(got.keys, b.keys)
            assert np.array_equal(got.values, b.values)
        store.cleanup()
