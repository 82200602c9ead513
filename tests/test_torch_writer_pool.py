"""The background spill writer pool of dampr_tpu_torch (``io/writer.py``):
bytes in flight bounded and charged to the budget, a failed write raised
by ``drain``, an aborted pool leaving no temp file and no charge, the
write -> fsync -> rename -> publish order, the synchronous path's
counters, and the run summary's ``io`` section.

The cases are ``tests/test_writer_pool.py``'s ``TestInflightBound``,
``TestKillDrain``, ``TestPublishOrder``, ``TestSyncPathParity`` and
``TestStatsSurface``, on blocks made from a seed with numpy.  Its
``TestResumeConsistency`` is in ``test_torch_resume.py``.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest

import dampr_tpu_torch.storage as storage_mod
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.io import codecs
from dampr_tpu_torch.runner import MTRunner
from dampr_tpu_torch.storage import RunStore

_RNG_BASE = np.random.RandomState(17).randint(0, 1 << 40, size=20000)


def _blk(n=20000, base=0):
    keys = np.sort(_RNG_BASE[:n]) + base
    return Block(keys.astype(np.int64), keys.astype(np.int64) * 2)


@pytest.fixture
def scratch(tmp_path):
    names = ("scratch_root", "spill_write_threads", "device")
    old = {n: getattr(settings, n) for n in names}
    settings.scratch_root = str(tmp_path / "scratch")
    settings.device = "cpu"
    yield tmp_path
    for n, v in old.items():
        setattr(settings, n, v)


@pytest.fixture
def codec(monkeypatch):
    """Install a codec object for every spill of the test."""
    def install(c):
        monkeypatch.setattr(storage_mod, "_spill_codec", lambda *a: c)
    return install


def _tmp_files(store):
    return glob.glob(os.path.join(store.root, "**", "*.tmp"), recursive=True)


class TestInflightBound:
    def test_inflight_bytes_never_exceed_cap(self, scratch, codec):
        """A write is admitted only under the cap, so the queued bytes
        (whose RAM is still held) never stack an unbounded backlog on top
        of the budget."""
        store = RunStore("pool-bound", budget=1 << 16, inflight_cap=1 << 18)
        peaks = []

        class SlowCodec(object):  # a backlog that persists
            cid = codecs.RAW

            def compress(self, data):
                time.sleep(0.002)
                peaks.append(store.spill_inflight_bytes)
                return data

        codec(SlowCodec())
        refs = [store.register(_blk(base=i)) for i in range(12)]
        store.drain_writes()
        blk_bytes = refs[0].nbytes
        cap = store.writer_pool().cap_bytes
        assert cap == 1 << 18
        # admission by the current backlog: the bound is cap + one block
        assert store.spill_inflight_peak_bytes <= cap + blk_bytes
        assert max(peaks) <= cap + blk_bytes
        for i, r in enumerate(refs):
            assert np.array_equal(r.get().keys, _blk(base=i).keys)
        store.cleanup()

    def test_default_cap_is_half_the_budget_at_least_4_mib(self, scratch):
        for budget, cap in ((1 << 30, 1 << 29), (1 << 16, 1 << 22)):
            store = RunStore("pool-cap", budget=budget)
            assert store.writer_pool().cap_bytes == cap
            store.cleanup()

    def test_inflight_charges_shrink_victim_target(self, scratch):
        """While a backlog exists, the victim selector's target shrinks by
        the bytes in flight."""
        store = RunStore("pool-target", budget=1 << 20)
        pool = store.writer_pool()
        assert pool is not None
        with pool._cv:
            pool.inflight_bytes = 1 << 20  # a full backlog
        try:
            ref = store.register(_blk())
            with pool._cv:
                pool.inflight_bytes -= 1 << 20
            store.drain_writes()
            assert not ref.resident and ref.path is not None
        finally:
            with pool._cv:
                pool.inflight_bytes = max(0, pool.inflight_bytes)
        store.cleanup()


class TestKillDrain:
    def test_abort_leaves_no_temp_files_and_no_charges(self, scratch, codec):
        store = RunStore("pool-abort", budget=1, inflight_cap=1 << 30)
        gate = threading.Event()

        class BlockingCodec(object):
            cid = codecs.RAW

            def compress(self, data):
                gate.wait(5.0)
                return data

        codec(BlockingCodec())
        refs = [store.register(_blk(base=i)) for i in range(6)]
        assert store.spill_inflight_bytes > 0
        gate.set()
        store.abort_writes()  # the failed run's drain
        assert store.spill_inflight_bytes == 0
        assert _tmp_files(store) == []
        # aborted refs keep their RAM blocks: nothing lost
        for i, r in enumerate(refs):
            assert np.array_equal(r.get().keys, _blk(base=i).keys)
        store.cleanup()

    def test_write_failure_surfaces_on_drain(self, scratch, codec):
        store = RunStore("pool-err", budget=1)

        class BoomCodec(object):
            cid = codecs.RAW

            def compress(self, data):
                raise OSError("disk exploded")

        codec(BoomCodec())
        ref = store.register(_blk())
        with pytest.raises(OSError, match="disk exploded"):
            store.drain_writes()
        # the data stays in RAM and no temp file is left
        assert ref.resident
        assert _tmp_files(store) == []
        store.cleanup()

    def test_failed_write_fails_the_run(self, scratch, codec):
        """A spill write that fails raises out of the run: no phase
        carries on past it."""
        class BoomCodec(object):
            cid = codecs.RAW

            def compress(self, data):
                raise OSError("disk exploded")

        codec(BoomCodec())
        pipe = Dampr.memory(list(range(5000)), partitions=4).checkpoint()
        runner = MTRunner("pool-fail", pipe.pmer.graph, memory_budget=1)
        with pytest.raises(OSError, match="disk exploded"):
            runner.run([pipe.source])
        assert _tmp_files(runner.store) == []
        assert runner.store.spill_inflight_bytes == 0
        runner.store.cleanup()


class TestPublishOrder:
    def test_block_readable_until_file_durable(self, scratch, codec):
        """Until the final file exists the ref answers from RAM; ``path``
        never names a temp or half-written file."""
        store = RunStore("pool-pub", budget=1)
        started = threading.Event()
        gate = threading.Event()

        class GatedCodec(object):
            cid = codecs.RAW

            def compress(self, data):
                started.set()
                gate.wait(5.0)
                return data

        codec(GatedCodec())
        try:
            ref = store.register(_blk())
            assert started.wait(5.0)
            assert ref.path is None and ref.resident
            assert len(ref.get()) == 20000
        finally:
            gate.set()
        store.drain_writes()
        assert ref.path is not None and not ref.resident
        assert os.path.exists(ref.path) and not ref.path.endswith(".tmp")
        assert np.array_equal(ref.get().keys, _blk().keys)
        store.cleanup()

    def test_dropped_ref_mid_write_leaks_nothing(self, scratch, codec):
        store = RunStore("pool-drop", budget=1)
        gate = threading.Event()

        class GatedCodec(object):
            cid = codecs.RAW

            def compress(self, data):
                gate.wait(5.0)
                return data

        codec(GatedCodec())
        ref = store.register(_blk())
        store.drop_ref(ref)  # the delete races the queued write
        gate.set()
        store.drain_writes()
        assert glob.glob(os.path.join(store.root, "**", "*.blk"),
                         recursive=True) == []
        store.cleanup()

    def test_concurrent_register_threads_stay_exact(self, scratch):
        store = RunStore("pool-conc", budget=1 << 16, inflight_cap=1 << 16)
        refs = [[] for _ in range(4)]

        def worker(t):
            for i in range(8):
                refs[t].append(
                    (t * 100 + i, store.register(_blk(4096, t * 100 + i))))

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
        store.drain_writes()
        for t in range(4):
            for base, r in refs[t]:
                assert np.array_equal(r.get().keys, _blk(4096, base).keys)
        store.cleanup()


class TestSyncPathParity:
    def test_sync_spills_feed_io_counters(self, scratch):
        """With no writer threads the spill lands before ``register``
        returns and still feeds the write-bandwidth counters."""
        settings.spill_write_threads = 0
        store = RunStore("sync-io", budget=1)
        ref = store.register(_blk())
        assert not ref.resident
        assert store.spill_count == 1
        assert store.spill_disk_bytes > 0
        assert store.spill_write_seconds > 0
        assert np.array_equal(ref.get().keys, _blk().keys)
        store.cleanup()

    def test_sync_and_pool_runs_read_back_the_same(self, scratch):
        """The synchronous path and the pool spill the same refs and read
        back the same records.  (Four chunks: four sorted runs, under the
        fan-in clamp's floor, so no merge generation drops a run while its
        write is queued.)"""
        rng = np.random.RandomState(9)
        data = rng.randint(0, 1000, size=20000).tolist()
        got = {}
        for threads in (0, 2):
            settings.spill_write_threads = threads
            pipe = (Dampr.memory(data, partitions=4)
                    .map(lambda x: x * 3).checkpoint())
            runner = MTRunner("sync-vs-pool-{}".format(threads),
                              pipe.pmer.graph, memory_budget=1 << 14)
            out = runner.run([pipe.source])
            got[threads] = (list(out[0].read()),
                            runner.run_summary["spill"]["count"])
            runner.store.cleanup()
        assert got[0] == got[2]
        assert got[0][1] > 0


class TestStatsSurface:
    def test_run_summary_gains_io_section(self, scratch):
        pipe = (Dampr.memory(list(range(50000)), partitions=8)
                .checkpoint(force=True))
        runner = MTRunner("pool-stats", pipe.pmer.graph,
                          memory_budget=1 << 14)
        out = runner.run([pipe.source])
        io = runner.run_summary["io"]
        for key in ("spill_write_bytes", "spill_write_seconds",
                    "spill_write_mbps", "spill_read_bytes",
                    "spill_read_seconds", "spill_read_mbps",
                    "io_wait_seconds", "io_wait_fraction",
                    "io_wait_write_seconds", "writer_threads",
                    "read_prefetch", "inflight_peak_bytes",
                    "writer_queue_peak"):
            assert key in io, key
        # the pool drains at every stage boundary, so every spill landed
        # before the summary; the final read then streams from disk (a
        # merge generation inside the run may still find a run in RAM)
        assert io["spill_write_bytes"] > 0
        assert runner.run_summary["spill"]["count"] > 0
        assert sorted(v for _k, v in out[0].read()) == list(range(50000))
        assert runner.store.spill_read_bytes > 0
        stages = runner.run_summary["stages"]
        assert sum(s["spill_count"] for s in stages) == \
            runner.run_summary["spill"]["count"]
        runner.store.cleanup()
