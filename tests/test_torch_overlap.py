"""The overlap executor of dampr_tpu_torch (``runner._overlap_stream``)
against the JAX package: a producer thread runs a map job's codec up to
``runner.OVERLAP_WINDOWS`` blocks ahead of the fold, every block in
flight charged to the memory budget.

The port versions of ``tests/test_overlap_executor.py``'s
``TestOverlapExactness``, ``TestOverlapMemory`` and
``test_consumer_abandonment_drains_reservations``: the same seeded
corpora and number files go through both packages, at several depths,
with equal records; no run leaves budget charged.  Then what the port
adds to hold: a codec failure on the producer thread, the device sink's
included, fails the run, and so does a producer that cannot be stopped.
Tolerance: exact.  Every producer thread is
joined with a timeout.
"""

import operator
import re
import threading
from collections import Counter

import numpy as np
import pytest

import dampr_tpu
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops.text import DocFreq as RefDocFreq
from dampr_tpu.ops.text import ParseNumbers as RefParseNumbers
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import Dampr, settings
from dampr_tpu_torch.blocks import Block
from dampr_tpu_torch.ops import lower as ops_lower
from dampr_tpu_torch.ops.text import DocFreq, ParseNumbers
from dampr_tpu_torch import runner as R
from dampr_tpu_torch.runner import MTRunner, _overlap_stream
from dampr_tpu_torch.storage import RunStore

_NAMES = ("partitions", "max_memory_per_stage", "overlap_windows",
          "scratch_root")
_PORT_NAMES = ("partitions", "max_memory_per_stage", "scratch_root",
               "device", "lower", "pipeline")


@pytest.fixture(autouse=True)
def knobs(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _NAMES}
    old = {n: getattr(settings, n) for n in _PORT_NAMES}
    old_depth = R.OVERLAP_WINDOWS
    old["handoff"] = settings.handoff
    settings.partitions = ref_settings.partitions = 8
    settings.device = "cpu"
    # the classic lowered program's blocks ride the overlap executor; the
    # handoff keeps them in its device vocabulary instead
    settings.handoff = "off"
    # the overlap executor's own bytes in flight: a streamed edge's early
    # folder charges its queue to the same budget counter (the JAX side's
    # 8-device rig bars streamed edges)
    settings.pipeline = "off"
    settings.scratch_root = str(tmp_path / "port")
    ref_settings.scratch_root = str(tmp_path / "ref")
    yield
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old.items():
        setattr(settings, n, v)
    R.OVERLAP_WINDOWS = old_depth


def _write_numbers(tmp_path, n, seed=11):
    ks = np.random.RandomState(seed).randint(0, 1 << 48, size=n)
    path = str(tmp_path / "nums.txt")
    with open(path, "w") as f:
        f.write("\n".join(str(k) for k in ks) + "\n")
    return path, ks


def _write_corpus(tmp_path, lines, seed=4):
    words = ["alpha", "beta", "Gamma", "delta", "tok7", "x9", "the"]
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "corpus.txt")
    with open(path, "w") as f:
        for _ in range(lines):
            f.write(" ".join(words[j]
                             for j in rng.randint(0, len(words), 9)) + "\n")
    return path


def _doc_freq_truth(path):
    rx = re.compile(r"[^\w]+")
    want = Counter()
    with open(path) as f:
        for line in f:
            want.update(t for t in set(rx.split(line.lower())) if t)
    return dict(want)


def _run_doc_freq(pkg_dampr, Runner, DF, path, chunk_size=1 << 15):
    df = (pkg_dampr.text(path, chunk_size)
          .custom_mapper(DF(mode="word", lower=True, pair_values=False))
          .fold_values(operator.add))
    runner = Runner("overlap-tfidf", df.pmer.graph)
    out = runner.run([df.source])
    got = {k: v[1] for k, v in out[0].read()}
    out[0].delete()
    return got, runner


def _run_sort(pkg_dampr, Runner, PN, path, chunk_size=1 << 17):
    pipe = (pkg_dampr.text(path, chunk_size).custom_mapper(PN())
            .checkpoint(force=True))
    runner = Runner("overlap-sort", pipe.pmer.graph)
    out = runner.run([pipe.source])
    return out[0], runner


class TestOverlapExactness:
    @pytest.mark.parametrize("lower", ["0", "1"])
    def test_tfidf_overlap_matches_serial(self, tmp_path, lower):
        path = _write_corpus(tmp_path, 6000)
        want, ref_runner = _run_doc_freq(dampr_tpu.Dampr, RefRunner,
                                         RefDocFreq, path)
        ref_runner.store.cleanup()
        assert want == _doc_freq_truth(path)
        settings.lower = lower
        for depth in (0, 3):
            R.OVERLAP_WINDOWS = depth
            got, runner = _run_doc_freq(Dampr, MTRunner, DocFreq, path)
            assert got == want, "depth={}".format(depth)
            assert runner.store.overlap_bytes == 0
            summary = runner.run_summary
            assert summary["io"]["overlap_bytes"] == 0
            assert (summary["io"]["overlap_peak_bytes"] > 0) == (depth > 0)
            assert (summary["device"]["device_stages"] > 0) == (lower == "1")
            runner.store.cleanup()

    def test_sort_overlap_matches_serial(self, tmp_path):
        path, ks = _write_numbers(tmp_path, 60000)
        settings.max_memory_per_stage = 1 << 20  # spilled runs
        ref_settings.max_memory_per_stage = 1 << 20
        ref_out, ref_runner = _run_sort(dampr_tpu.Dampr, RefRunner,
                                        RefParseNumbers, path)
        want = [k for k, _v in ref_out.read()]
        ref_out.delete()
        ref_runner.store.cleanup()
        assert want == sorted(ks.tolist())
        for depth in (0, 2):
            R.OVERLAP_WINDOWS = depth
            out, runner = _run_sort(Dampr, MTRunner, ParseNumbers, path)
            assert [k for k, _v in out.read()] == want, depth
            assert runner.store.overlap_bytes == 0
            out.delete()
            runner.store.cleanup()


class TestOverlapMemory:
    def test_reserve_displaces_resident_blocks(self):
        store = RunStore("overlap-governor", budget=1 << 20)
        arr = np.arange(40000, dtype=np.int64)
        ref = store.register(Block(arr.copy(), arr.copy()))
        assert ref.resident
        store.reserve_overlap(1 << 20)  # the whole budget in flight
        store.drain_writes()
        assert not ref.resident and ref.path is not None
        assert store.spill_count >= 1
        store.release_overlap(1 << 20)
        assert store.overlap_bytes == 0
        assert store.overlap_peak_bytes == 1 << 20
        assert np.array_equal(ref.get().keys, arr)
        store.cleanup()

    def test_in_flight_bytes_bounded_by_depth(self, tmp_path):
        """The high-water mark stays within (depth + 2) blocks per job
        (queue slots, the producer's block in hand, the one folding),
        never the whole codec output."""
        path, _ks = _write_numbers(tmp_path, 80000)
        depth = 2
        R.OVERLAP_WINDOWS = depth
        settings.scan_window_bytes, old = 1 << 16, settings.scan_window_bytes
        try:
            out, runner = _run_sort(Dampr, MTRunner, ParseNumbers, path,
                                    chunk_size=1 << 18)
        finally:
            settings.scan_window_bytes = old
        total_out = sum(r.nbytes for r in out.pset.all_refs())
        peak = runner.store.overlap_peak_bytes
        assert peak > 0, "overlap executor never engaged"
        # a 64 KiB window of ~15-byte lines parses to two int64 lanes
        per_block = (1 << 16) * 2
        assert peak <= (depth + 2) * settings.max_processes * per_block
        assert peak < total_out
        assert runner.store.overlap_bytes == 0
        out.delete()
        runner.store.cleanup()

    def test_consumer_abandonment_drains_reservations(self):
        store = RunStore("overlap-drain", budget=1 << 22)
        R.OVERLAP_WINDOWS = 2

        def codec():
            for _ in range(50):
                arr = np.arange(1000, dtype=np.int64)
                yield Block(arr, arr.copy())

        before = set(threading.enumerate())
        with pytest.raises(RuntimeError):
            for i, _blk in enumerate(_overlap_stream(codec(), store)):
                if i == 3:
                    raise RuntimeError("fold died")
        assert store.overlap_bytes == 0
        assert not [t for t in set(threading.enumerate()) - before
                    if t.name == "dampr-codec" and t.is_alive()]
        store.cleanup()


class TestProducerFailures:
    def test_a_producer_that_does_not_stop_fails_the_run(self,
                                                         monkeypatch):
        """A consumer that stops while the codec is stuck waits for the
        producer, then raises: the producer may still hold a budget
        charge or drive the device sink."""
        store = RunStore("overlap-stuck", budget=1 << 22)
        R.OVERLAP_WINDOWS = 2
        monkeypatch.setattr(R, "_PRODUCER_JOIN_SECONDS", 0.2)
        gate = threading.Event()

        def codec():
            arr = np.arange(10, dtype=np.int64)
            yield Block(arr, arr.copy())
            assert gate.wait(10)  # stuck inside the codec

        stream = _overlap_stream(codec(), store)
        assert len(next(stream)) == 10
        with pytest.raises(RuntimeError, match="did not stop"):
            stream.close()
        gate.set()
        for t in threading.enumerate():
            if t.name == "dampr-codec":
                t.join(5)
                assert not t.is_alive()
        assert store.overlap_bytes == 0
        store.cleanup()

    def test_producer_error_raises_on_the_consumer(self):
        store = RunStore("overlap-error", budget=1 << 22)
        R.OVERLAP_WINDOWS = 2

        def codec():
            arr = np.arange(10, dtype=np.int64)
            yield Block(arr, arr.copy())
            raise IOError("inflate failed")

        got = []
        with pytest.raises(IOError, match="inflate failed"):
            for blk in _overlap_stream(codec(), store):
                got.append(len(blk))
        assert got == [10]
        assert store.overlap_bytes == 0
        store.cleanup()

    @pytest.mark.parametrize("depth", [0, 2])
    def test_device_sink_failure_fails_the_run(self, tmp_path, monkeypatch,
                                               depth):
        """A launch that fails inside the lowered sink fails the run: no
        host path takes over and no record goes missing quietly."""
        path = _write_corpus(tmp_path, 500)
        settings.lower = "1"
        R.OVERLAP_WINDOWS = depth

        def broken(*args, **kwargs):
            raise RuntimeError("kernel launch failed")

        monkeypatch.setattr(ops_lower, "token_fold", broken)
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            _run_doc_freq(Dampr, MTRunner, DocFreq, path)
