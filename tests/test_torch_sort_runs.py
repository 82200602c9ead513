"""Sorted-run mode and the external sort of dampr_tpu_torch, held against
the JAX package on the same records.

A map stage whose output no reduce consumes registers one key-sorted run
per job; the final read merges the runs directly under
``settings.merge_fanin`` and after streamed merge generations past it.
Object and NaN keys fall back to hash fan-out.  ``ParseNumbers`` parses
one number a line (natively for int64).  The cases are
``tests/test_overlap_executor.py::TestSortedRunPlanning`` and the
``ParseNumbers`` cases of ``tests/test_text_kernels.py``, on records made
from a seed with numpy; every comparison is exact, order included.
"""

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import dampr_tpu
import dampr_tpu_torch
from dampr_tpu import native as ref_native
from dampr_tpu import settings as ref_settings
from dampr_tpu.ops.text import ParseNumbers as RefParseNumbers
from dampr_tpu.runner import MTRunner as RefRunner
from dampr_tpu_torch import native, settings
from dampr_tpu_torch.ops.text import ParseNumbers
from dampr_tpu_torch.runner import MTRunner, OutputDataset
from dampr_tpu_torch.storage import PartitionSet

def _ref_parse_i64(buf, wait_s=60.0):
    """The JAX package's native parse.  Its library compiles in place on
    first use, so a test worker that maps it while another worker is still
    writing it gets no library for the process (its loader gives up for
    good); load it again until the file is whole."""
    deadline = time.monotonic() + wait_s
    while ref_native.get_lib() is None and time.monotonic() < deadline:
        ref_native._tried = False
        time.sleep(0.2)
    return ref_native.parse_i64(buf)


_NAMES = ("partitions", "max_memory_per_stage", "merge_fanin",
          "scratch_root", "seed", "max_processes")


@pytest.fixture(autouse=True)
def knobs(tmp_path):
    old_ref = {n: getattr(ref_settings, n) for n in _NAMES}
    old_port = {n: getattr(settings, n) for n in _NAMES + ("device",)}
    ref_settings.partitions = settings.partitions = 8
    ref_settings.scratch_root = str(tmp_path / "ref")
    settings.scratch_root = str(tmp_path / "port")
    settings.device = "cpu"
    yield
    for n, v in old_ref.items():
        setattr(ref_settings, n, v)
    for n, v in old_port.items():
        setattr(settings, n, v)


def _write_numbers(tmp_path, n, seed=11):
    ks = np.random.RandomState(seed).randint(0, 1 << 48, size=n)
    path = str(tmp_path / "nums.txt")
    with open(path, "w") as f:
        f.write("\n".join(str(k) for k in ks) + "\n")
    return path, ks


def _run_sort(pkg, path, chunk_size):
    Parse, Runner = ((ParseNumbers, MTRunner) if pkg is dampr_tpu_torch
                     else (RefParseNumbers, RefRunner))
    pipe = (pkg.Dampr.text(path, chunk_size).custom_mapper(Parse())
            .checkpoint(force=True))
    runner = Runner("sort", pipe.pmer.graph)
    out = runner.run([pipe.source])[0]
    return out, runner


def _set(name, value):
    setattr(ref_settings, name, value)
    setattr(settings, name, value)


class TestSortedRunPlanning:
    def test_direct_feed_under_fanin(self, tmp_path):
        """The fan-in fits: no merge generation, the read feeds straight
        from the first-level runs."""
        path, ks = _write_numbers(tmp_path, 120000)
        _set("max_memory_per_stage", 64 * 1024 * 1024)
        out, runner = _run_sort(dampr_tpu_torch, path, 1 << 18)
        ref_out, ref_runner = _run_sort(dampr_tpu, path, 1 << 18)
        assert out.pset.key_sorted_runs
        assert runner.store.merge_gens == 0 == ref_runner.store.merge_gens
        got = list(out.read())
        assert got == list(ref_out.read())
        assert [k for k, _v in got] == sorted(ks.tolist())
        for o, r in ((out, runner), (ref_out, ref_runner)):
            o.delete()
            r.store.cleanup()

    @pytest.mark.parametrize("budget", [None, 1 << 20])
    def test_merge_generations_past_fanin(self, tmp_path, budget):
        """Past the fan-in, runs merge file to file until the count fits;
        with a tight budget the runs spill first."""
        path, ks = _write_numbers(tmp_path, 150000)
        _set("merge_fanin", 2)
        if budget is not None:
            _set("max_memory_per_stage", budget)
        out, runner = _run_sort(dampr_tpu_torch, path, 1 << 17)
        ref_out, ref_runner = _run_sort(dampr_tpu, path, 1 << 17)
        assert out.pset.key_sorted_runs
        assert runner.store.merge_gens >= 1
        assert len(out.pset.parts.get(0, [])) <= 2
        if budget is not None:
            assert runner.run_summary["spill"]["count"] > 0
        got = list(out.read())
        assert got == list(ref_out.read())
        assert [k for k, _v in got] == sorted(ks.tolist())
        keys = np.concatenate([b.keys for b in out.sorted_blocks()])
        assert np.array_equal(keys, np.sort(ks))
        for o, r in ((out, runner), (ref_out, ref_runner)):
            o.delete()
            r.store.cleanup()

    def test_object_keys_fall_back_to_hash_fanout(self):
        items = ["b", "a", "c", "aa", "z"] * 50

        def build(pkg):
            return pkg.Dampr.memory(items).sort_by(lambda v: v)

        pipe = build(dampr_tpu_torch)
        out = MTRunner("runs-fallback", pipe.pmer.graph).run([pipe.source])
        assert not out[0].pset.key_sorted_runs
        got = list(out[0].read())
        ref = build(dampr_tpu)
        want = RefRunner("runs-fallback", ref.pmer.graph).run([ref.source])
        assert got == list(want[0].read())
        assert [v for _k, v in got] == sorted(items)

    def test_nan_keys_fall_back_to_hash_fanout(self):
        items = [3.5, float("nan"), 1.25, 2.0, float("nan"), 0.5] * 40

        def build(pkg):
            return pkg.Dampr.memory(items).sort_by(lambda v: v)

        pipe = build(dampr_tpu_torch)
        out = MTRunner("runs-nan", pipe.pmer.graph).run([pipe.source])
        assert not out[0].pset.key_sorted_runs
        got = [v for _k, v in out[0].read()]
        want = build(dampr_tpu).read()
        assert repr(got) == repr(want)
        assert [v for v in got if v == v] == sorted(v for v in items
                                                    if v == v)
        assert sum(1 for v in got if v != v) == 80

    def test_checkpoint_then_reduce_regroups(self, tmp_path):
        """A reduce behind a forced checkpoint: the map keeps hash fan-out
        and grouping is global and exact, in one executed map stage."""
        _path, ks = _write_numbers(tmp_path, 5000, seed=3)
        small = [int(k) % 97 for k in ks]
        spath = str(tmp_path / "small.txt")
        with open(spath, "w") as f:
            f.write("\n".join(str(v) for v in small) + "\n")

        def keyed_sum(groups):
            for k, vs in groups:
                yield k, sum(v[1] if isinstance(v, tuple) else v
                             for v in vs)

        def build(pkg, parse):
            return (pkg.Dampr.text(spath, chunk_size=1 << 14)
                    .custom_mapper(parse())
                    .checkpoint(force=True)
                    .partition_reduce(keyed_sum))

        em = build(dampr_tpu_torch, ParseNumbers).run()
        got = em.read()
        assert got == build(dampr_tpu, RefParseNumbers).read()
        want = {}
        for v in small:
            want[v] = want.get(v, 0) + v
        assert dict(got) == want
        maps = [s for s in em.stats()["stages"] if s["kind"] == "map"]
        assert len(maps) == 1 and maps[0]["op"] == "ParseNumbers"


def test_sorted_runs_read_back_as_the_hash_fanout_does(tmp_path):
    """The same records hash-fanned into partitions (what a job whose keys
    do not qualify registers) read back as the run merge does."""
    path, ks = _write_numbers(tmp_path, 40000, seed=5)
    out, runner = _run_sort(dampr_tpu_torch, path, 1 << 16)
    assert out.pset.key_sorted_runs
    runs = list(out.read())
    fanned = PartitionSet(settings.partitions)
    for ref in out.pset.all_refs():
        for pid, sub in ref.get().split_by_partition(
                settings.partitions).items():
            fanned.add(pid, runner.store.register(sub))
    assert list(OutputDataset(fanned, runner.store).read()) == runs
    assert [k for k, _v in runs] == sorted(ks.tolist())
    runner.store.cleanup()


def test_seeded_sample_after_a_map_stage_equals_the_jax_package():
    """A seeded ``sample()`` behind a map stage sees the map's sorted
    runs, in the JAX package's order, and keeps the same records."""
    _set("seed", 5)
    _set("max_processes", 1)  # one job thread: one random sequence

    def build(pkg, parts, barrier):
        p = pkg.Dampr.memory(list(range(200)), partitions=parts).map(
            lambda x: x + 1)
        if barrier:
            p = p.checkpoint()
        return p.sample(0.5).map(lambda x: x * 2)

    for parts in (1, 4):
        for barrier in (False, True):
            got = build(dampr_tpu_torch, parts, barrier).read()
            assert got == build(dampr_tpu, parts, barrier).read()
            assert 50 < len(got) < 150


class _Bytes(object):
    def __init__(self, data):
        self._data = data

    def read_bytes(self):
        return self._data


class TestParseNumbers:
    @pytest.mark.parametrize("dtype", [np.int64, np.float64])
    def test_block_path_equals_the_jax_package(self, dtype):
        rng = np.random.RandomState(6)
        nums = (rng.randint(-2 ** 62, 2 ** 62, size=3000) if dtype is np.int64
                else rng.randn(3000) * 1e6)
        data = ("\n".join(repr(x) if dtype is np.float64 else str(x)
                          for x in nums.tolist()) + "\n").encode()
        got = [b for b in ParseNumbers(dtype).map_blocks(_Bytes(data))]
        want = [b for b in RefParseNumbers(dtype).map_blocks(_Bytes(data))]
        assert len(got) == len(want) == 1
        assert got[0].keys.dtype == want[0].keys.dtype == np.dtype(dtype)
        assert np.array_equal(got[0].keys, want[0].keys)
        assert np.array_equal(got[0].values, nums.astype(dtype))

    def test_parse_numbers_no_fromstring(self):
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")  # any DeprecationWarning fails
            blocks = list(ParseNumbers().map_blocks(_Bytes(b"3\n1\n2\n")))
        assert sorted(v for _k, v in blocks[0].iter_pairs()) == [1, 2, 3]
        with pytest.raises(ValueError):
            list(ParseNumbers().map_blocks(_Bytes(b"1\nnope\n")))

    def test_parse_i64_matches_numpy_and_the_jax_package(self):
        assert native.get_lib() is not None
        data = b"3\n-17\n0\n+9\n9223372036854775807\n-9223372036854775808\n"
        buf = np.frombuffer(data, dtype=np.uint8)
        arr = native.parse_i64(buf)
        np.testing.assert_array_equal(arr, np.array(data.split(),
                                                    dtype=np.int64))
        np.testing.assert_array_equal(arr, _ref_parse_i64(buf))

    def test_failed_load_retries_once_the_library_changes(self, tmp_path,
                                                          monkeypatch):
        """A load that failed (another process still writing the shared
        object) is retried once the file has changed, not given up for
        the process."""
        good = native._SO
        assert native.get_lib() is not None
        so = str(tmp_path / "libtokenizer.so")
        with open(so, "wb") as f:
            f.write(b"\x7fELF half written")
        os.utime(so, (1, 1))
        monkeypatch.setattr(native, "_SO", so)
        monkeypatch.setattr(native, "_build", lambda: None)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_failed_mtime", None)
        assert native.get_lib() is None
        assert native.get_lib() is None  # same file: no second attempt
        shutil.copyfile(good, so)
        assert native.get_lib() is not None
        np.testing.assert_array_equal(
            native.parse_i64(np.frombuffer(b"5 -6\n", dtype=np.uint8)),
            [5, -6])

    def test_concurrent_first_builds_compile_once(self, tmp_path):
        """Four processes that find no library build it under the lock
        file: exactly one compiles (each build appends a line to a log),
        the others load its result; all parse."""
        so = str(tmp_path / "_build" / "libtokenizer.so")
        builds = str(tmp_path / "builds.log")
        # the module alone, loaded from its file: no package (and no torch)
        # import in the child processes
        code = ("import importlib.util, os, sys, numpy as np\n"
                "spec = importlib.util.spec_from_file_location(\n"
                "    'native', sys.argv[1])\n"
                "native = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(native)\n"
                "native._SO = sys.argv[2]\n"
                "real = native._build\n"
                "def counted():\n"
                "    with open(sys.argv[3], 'a') as f:\n"
                "        f.write('%d\\n' % os.getpid())\n"
                "    real()\n"
                "native._build = counted\n"
                "arr = native.parse_i64(np.frombuffer(b'7 8', np.uint8))\n"
                "print(None if arr is None else arr.tolist())\n")
        procs = [subprocess.Popen([sys.executable, "-c", code,
                                   native.__file__, so, builds],
                                  stdout=subprocess.PIPE)
                 for _ in range(4)]
        outs = [p.communicate(timeout=120)[0].decode().strip()
                for p in procs]
        assert outs == ["[7, 8]"] * 4
        assert [p.returncode for p in procs] == [0] * 4
        with open(builds) as f:
            assert len(f.read().split()) == 1

    @pytest.mark.parametrize("bad", [b"1\nx\n", b"12a\n",
                                     b"9223372036854775808\n",
                                     b"-9223372036854775809\n", b"-\n"])
    def test_parse_i64_rejects_junk_and_overflow(self, bad):
        with pytest.raises(ValueError):
            native.parse_i64(np.frombuffer(bad, dtype=np.uint8))

    def test_record_path_equals_the_block_path(self, tmp_path):
        path, ks = _write_numbers(tmp_path, 3000, seed=8)
        with open(path, "a") as f:
            f.write("\n  \n")  # blank lines parse to nothing either way
        from dampr_tpu_torch.dataset import TextLineDataset

        rec = [k for k, _v in ParseNumbers().map(TextLineDataset(path))]
        blk = np.concatenate([b.keys for b in ParseNumbers().map_blocks(
            TextLineDataset(path))])
        assert rec == blk.tolist() == ks.tolist()
